"""Generic autoregressive flow: conditioner + transformer composition.

Port of ``tfep_tpu/nn/flows/autoregressive.py``. Forward is one conditioner
pass plus one transformer apply. Inverse runs one conditioner pass per
autoregressive degree group, as a Python loop (the JAX package rolls it
into a ``lax.fori_loop``), on one of three paths: the fast path (only the
group's conditioner rows and transformer features), the row-restricted
path (only the group's conditioner rows, the transformer at full width),
and the looped path (full passes).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.nn.flows.flow import Flow

__all__ = ['AutoregressiveFlow']


class AutoregressiveFlow(Flow):
    """Autoregressive flow parametrized by a conditioner and a transformer.

    ``transformer_indices`` groups the transformed feature indices by
    autoregressive order; features absent from it are fixed (propagated
    unchanged). The conditioner must be autoregressive over the same
    degree ordering. The inverse resolves one degree group per iteration:
    group ``i``'s inputs depend only on groups ``< i``, so after ``i``
    conditioner passes those features are exact.

    Build with :meth:`create`. Buffers, with the JAX package's names:
    ``transformer_indices_buf`` (sorted transformed features, or None when
    all are), ``inverse_masks`` (``(n_groups, n_features)`` bool: which
    features resolve at each iteration), ``fixed_indices`` (possibly
    empty) and ``conditioner_indices`` (the features the conditioner sees,
    or None for all).
    """

    def __init__(self, conditioner, transformer, transformer_indices_buf,
                 inverse_masks, fixed_indices, conditioner_indices,
                 n_features_in: int, inverse_groups_t=None,
                 inverse_param_rows=None):
        super().__init__()
        self.conditioner = conditioner
        self.transformer = transformer
        self.register_buffer('transformer_indices_buf',
                             transformer_indices_buf)
        self.register_buffer('inverse_masks', inverse_masks)
        self.register_buffer('fixed_indices', fixed_indices)
        self.register_buffer('conditioner_indices', conditioner_indices)
        self.n_features_in = int(n_features_in)
        # Per degree group: the group's positions within the transformed
        # set (fast inverse) and its conditioner-output rows (row-restricted
        # inverse). Host tuples, one entry per group, not padded: the loop
        # runs on the host, so groups may differ in size.
        self.inverse_groups_t = inverse_groups_t
        self.inverse_param_rows = inverse_param_rows

    @classmethod
    def create(cls, n_features_in: int, transformer_indices,
               conditioner, transformer,
               conditioner_indices=None,
               initialize_identity: bool = True,
               inverse_param_rows=None,
               device=None) -> 'AutoregressiveFlow':
        """Build the flow from index groups + conditioner + transformer.

        Parameters
        ----------
        n_features_in : int
            Total input feature count.
        transformer_indices : sequence of sequence of int
            Transformed feature indices grouped by autoregressive degree
            (group ``i`` may depend on groups ``< i`` only). Features in
            no group are propagated unchanged.
        conditioner : Conditioner
            Autoregressive parameter network.
        transformer : Transformer
            Elementwise bijection.
        conditioner_indices : sequence of int, optional
            Subset of input features the conditioner sees (default: all).
        initialize_identity : bool, optional
            If ``True`` (default), zero the conditioner's output layer and
            bias it to the transformer's identity parameters so the flow
            starts as the identity map.
        inverse_param_rows : sequence of sequence of int, optional
            For each degree group, the conditioner-output rows holding that
            group's transformer parameters. Enables the row-restricted
            inverse for transformers without ``slice_features``.
        device : str or torch.device, optional
            Where the index buffers live. Defaults to ``cuda``; raises
            without a card.

        Returns
        -------
        AutoregressiveFlow
        """
        device = resolve_device(device)
        groups = [np.asarray(g).reshape(-1) for g in transformer_indices]
        for g in groups:
            if np.any((g < 0) | (g >= n_features_in)):
                raise ValueError('All indices must be 0 <= i < n_features_in.')
        if inverse_param_rows is not None \
                and len(inverse_param_rows) != len(groups):
            raise ValueError(
                f'inverse_param_rows must have one entry per transformer '
                f'group ({len(groups)}), got {len(inverse_param_rows)}.')
        # Empty groups contribute nothing but a no-op inverse iteration.
        if any(len(g) == 0 for g in groups):
            keep = [i for i, g in enumerate(groups) if len(g)]
            if inverse_param_rows is not None:
                inverse_param_rows = [inverse_param_rows[i] for i in keep]
            groups = [groups[i] for i in keep]
        if conditioner_indices is not None:
            conditioner_indices = np.asarray(conditioner_indices)
            if np.any((conditioner_indices < 0) |
                      (conditioner_indices >= n_features_in)):
                raise ValueError('All indices must be 0 <= i < n_features_in.')

        inverse_masks = np.zeros((len(groups), n_features_in), dtype=bool)
        for i, g in enumerate(groups):
            inverse_masks[i, g] = True

        all_transformed = np.sort(np.concatenate(groups)) if groups else \
            np.zeros(0, dtype=np.int64)
        fixed = np.setdiff1d(np.arange(n_features_in), all_transformed)

        if initialize_identity:
            conditioner.set_output(transformer.get_identity_parameters(
                len(all_transformed)))

        position = {int(f): p for p, f in enumerate(all_transformed)}
        groups_t = tuple(tuple(position[int(f)] for f in g) for g in groups)

        if inverse_param_rows is not None:
            inverse_param_rows = tuple(
                tuple(int(r) for r in np.asarray(rows).reshape(-1))
                for rows in inverse_param_rows)
            if any(len(r) == 0 for r in inverse_param_rows):
                raise ValueError(
                    'inverse_param_rows needs one non-empty row list per '
                    'transformer_indices group.')

        def index(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=device)

        return cls(
            conditioner=conditioner,
            transformer=transformer,
            transformer_indices_buf=(
                index(all_transformed) if len(fixed) > 0 else None),
            inverse_masks=torch.as_tensor(inverse_masks, device=device),
            fixed_indices=index(fixed),
            conditioner_indices=(None if conditioner_indices is None
                                 else index(conditioner_indices)),
            n_features_in=n_features_in,
            inverse_groups_t=groups_t,
            inverse_param_rows=inverse_param_rows,
        )

    @property
    def has_fixed_indices(self) -> bool:
        return self.transformer_indices_buf is not None

    def get_transformer_parameters(self, x: torch.Tensor) -> torch.Tensor:
        return self.conditioner(self._conditioner_input(x))

    def forward(self, x: torch.Tensor):
        """One conditioner pass + one transformer apply.

        Returns ``(y, log_det_J)`` with shapes ``(batch, n_features)`` and
        ``(batch,)``.
        """
        parameters = self.get_transformer_parameters(x)
        if self.has_fixed_indices:
            idx = self.transformer_indices_buf
            y_t, log_det_J = self.transformer(x[:, idx], parameters)
            y = x.index_copy(1, idx, y_t)
        else:
            y, log_det_J = self.transformer(x, parameters)
        return y, log_det_J

    @property
    def _can_fast_inverse(self) -> bool:
        """Whether the restricted (per-group) inverse path applies.

        Requires a conditioner exposing ``forward_rows`` (e.g. MADE), a
        transformer exposing ``slice_features`` (only transformers with the
        tiled parameter layout ``(batch, n_parameters_per_feature,
        n_features)``), and the group table built by :meth:`create`.
        """
        return (self.inverse_groups_t is not None
                and len(self.inverse_groups_t) > 0
                and hasattr(self.conditioner, 'forward_rows')
                and hasattr(self.transformer, 'slice_features')
                and getattr(self.transformer, 'n_parameters_per_feature',
                            None) is not None)

    @property
    def _can_row_restricted_inverse(self) -> bool:
        """Whether the layout-agnostic restricted inverse applies: needs
        the per-group conditioner-row table and a row-restrictable
        conditioner. The transformer's identity parameters fill the rows
        outside the current group; a transformer that cannot express the
        identity falls back to the looped path."""
        return (self.inverse_param_rows is not None
                and len(self.inverse_param_rows) > 0
                and hasattr(self.conditioner, 'forward_rows'))

    def _conditioner_input(self, x):
        if self.conditioner_indices is not None:
            return x[:, self.conditioner_indices]
        return x

    def _masked_update(self, x, x_temp, mask_t):
        idx = self.transformer_indices_buf
        if idx is not None:
            return x.index_copy(1, idx, torch.where(
                mask_t[None, :], x_temp, x[:, idx]))
        return torch.where(mask_t[None, :], x_temp, x)

    def inverse(self, y: torch.Tensor):
        """Exact inverse in ``n_degree_groups`` conditioner passes.

        Returns ``(x, log_det_J)`` where ``log_det_J`` is the inverse map's
        log-det, taken from the final (fully resolved) full transformer
        pass, whichever path ran before it.
        """
        n_iterations = self.inverse_masks.shape[0]
        idx = self.transformer_indices_buf
        if idx is not None:
            y_t = y[:, idx]
            # Masks over the transformer feature axis.
            inverse_masks_t = self.inverse_masks[:, idx]
        else:
            y_t = y
            inverse_masks_t = self.inverse_masks

        x = torch.where(self.inverse_masks.any(dim=0)[None, :],
                        torch.zeros_like(y), y)

        if self._can_fast_inverse:
            n_t = y_t.shape[1]
            n_per = self.transformer.n_parameters_per_feature
            for i in range(n_iterations - 1):
                g = torch.as_tensor(self.inverse_groups_t[i],
                                    device=y.device)
                # Conditioner output rows of group g's parameters in the
                # tiled layout: row k*n_t + g_j, ordered so the restricted
                # output IS the sliced transformer's parameter vector.
                rows = (torch.arange(n_per, device=y.device)[:, None] * n_t
                        + g[None, :]).reshape(-1)
                params_g = self.conditioner.forward_rows(
                    self._conditioner_input(x), rows)
                x_g, _ = self.transformer.slice_features(g).inverse(
                    y_t[:, g], params_g)
                pos = g if idx is None else idx[g]
                x = x.index_copy(1, pos, x_g)
        elif self._can_row_restricted_inverse and (
                identity := _identity_parameters_or_none(
                    self.transformer, y_t.shape[1], y)) is not None:
            # Only the group's conditioner-output rows are computed and
            # scattered into an identity-parameter fill; positions outside
            # the group see the identity transform and are discarded by
            # the masked update.
            for i in range(n_iterations - 1):
                rows = torch.as_tensor(self.inverse_param_rows[i],
                                       device=y.device)
                values = self.conditioner.forward_rows(
                    self._conditioner_input(x), rows)
                parameters = identity.expand(
                    x.shape[0], -1).index_copy(1, rows, values)
                x_temp, _ = self.transformer.inverse(y_t, parameters)
                x = self._masked_update(x, x_temp, inverse_masks_t[i])
        else:
            for i in range(n_iterations - 1):
                x_temp, _ = self.transformer.inverse(
                    y_t, self.get_transformer_parameters(x))
                x = self._masked_update(x, x_temp, inverse_masks_t[i])
        # The last group is resolved by a full pass, whose log_det_J is the
        # total one.
        x_temp, log_det_J = self.transformer.inverse(
            y_t, self.get_transformer_parameters(x))
        x = self._masked_update(x, x_temp, inverse_masks_t[-1])
        return x, log_det_J


def _identity_parameters_or_none(transformer, n_features: int,
                                 like: torch.Tensor) -> Optional[torch.Tensor]:
    """The transformer's identity parameters as a tensor like ``like``, or
    ``None`` when the transformer cannot express the identity (e.g. a
    neural spline with x0 != y0)."""
    try:
        identity = transformer.get_identity_parameters(n_features)
    except (ValueError, NotImplementedError):
        return None
    return torch.as_tensor(identity, dtype=like.dtype, device=like.device)
