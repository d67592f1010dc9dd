"""Centered-centroid flow: constrains the (weighted) centroid of the points.

Port of ``tfep_tpu/nn/flows/centroid.py``. Translates the configuration so
its (weighted) centroid sits at a chosen origin, holds one point's DOFs out
of the wrapped flow, restores the centroid constraint on the output through
that fixed point, and optionally translates back. Every step builds a new
tensor (``index_copy`` in place of the JAX package's ``.at[].set``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tfep_tpu_torch.nn.flows.partial import PartialFlow

__all__ = ['CenteredCentroidFlow']


class CenteredCentroidFlow(PartialFlow):
    """Wraps a flow, fixing the centroid of (a subset of) the points.

    On the forward (and inverse) pass it:

    1. translates the configuration so the (weighted) centroid of the
       chosen point subset sits at ``origin``;
    2. runs the wrapped flow on all degrees of freedom except those of
       ``fixed_point_idx`` (held out through the :class:`PartialFlow`
       machinery);
    3. solves for the fixed point's coordinates so the output centroid is
       again at ``origin``;
    4. optionally (``translate_back=True``) undoes the initial translation
       so input and output live in the original frame.

    Steps 1 and 4 are rigid translations and step 3 determines the fixed
    point from the constraint, so the log-Jacobian is that of the wrapped
    flow on the reduced set. Build with :meth:`create`, which takes these
    arguments and ``device``.

    Parameters
    ----------
    flow : Flow
        The wrapped flow. It will receive
        ``n_features - space_dimension`` features (the fixed point's
        DOFs are held out).
    space_dimension : int
        Dimensionality of each point (3 for atoms).
    n_features : int
        Total flattened DOF count of the input, i.e.
        ``n_points * space_dimension``.
    subset_point_indices : sequence of int, optional
        Point (atom) indices over which the centroid is computed.
        Default: all points.
    weights : sequence of float, optional
        Centroid weights, one per subset point (normalized internally).
        Pass masses for a center-of-mass constraint.
    fixed_point_idx : int, optional
        Which point absorbs the constraint. Indexes into
        ``subset_point_indices`` when one is given, into all points
        otherwise. Default 0.
    origin : sequence of float, optional
        ``(space_dimension,)`` target centroid position. Default: the
        origin of the coordinate system.
    translate_back : bool, optional
        If ``True`` (default) the output is translated back to the
        input frame; required for :meth:`inverse` to be defined.
    return_partial : bool, optional
        If ``True``, return only the propagated (non-fixed) features.
        Incompatible with ``translate_back=True``.
    dtype : torch.dtype, optional
        Type of the floating-point buffers (``weights``, ``origin``).

    Raises
    ------
    ValueError
        If ``origin`` has the wrong length, ``weights`` and
        ``subset_point_indices`` disagree in length, or
        ``return_partial`` conflicts with ``translate_back``.

    Notes
    -----
    Buffers, named as the JAX module's leaves: ``subset_point_indices``
    (integer, or None for all points), ``weights`` (``(n_subset_points,
    1)`` normalized, or None for uniform) and ``origin``
    (``(space_dimension,)``), besides :class:`PartialFlow`'s.
    """

    def __init__(self, flow, space_dimension: int, n_features: int,
                 subset_point_indices: Optional[Sequence[int]] = None,
                 weights: Optional[Sequence[float]] = None,
                 fixed_point_idx: int = 0,
                 origin: Optional[Sequence[float]] = None,
                 translate_back: bool = True,
                 return_partial: bool = False,
                 dtype: torch.dtype = torch.float32):
        if return_partial and translate_back:
            raise ValueError("'return_partial=True' is supported only if "
                             "'translate_back=False'")
        if origin is None:
            origin = np.zeros(space_dimension)
        else:
            origin = np.asarray(origin, dtype=float)
            if len(origin) != space_dimension:
                raise ValueError(
                    "'origin' must have length equal to 'space_dimension'.")

        if subset_point_indices is None:
            subset_fixed_point_idx = fixed_point_idx
        else:
            subset_point_indices = np.asarray(subset_point_indices,
                                              dtype=np.int64)
            subset_fixed_point_idx = int(
                subset_point_indices[fixed_point_idx])
            if weights is not None and \
                    len(weights) != len(subset_point_indices):
                raise ValueError("'weights' must have the same length as "
                                 "'subset_point_indices'.")

        # Flattened DOF indices of the fixed point (any space dimension).
        fixed_indices = (subset_fixed_point_idx * space_dimension
                         + np.arange(space_dimension))
        super().__init__(flow, fixed_indices, n_features=n_features,
                         return_partial=return_partial)

        if weights is not None:
            weights = np.asarray(weights, dtype=float)
            weights = torch.as_tensor((weights / weights.sum())[:, None],
                                      dtype=dtype)
        self.space_dimension = int(space_dimension)
        self.fixed_point_idx = int(fixed_point_idx)
        self.translate_back = bool(translate_back)
        self.register_buffer(
            'subset_point_indices',
            None if subset_point_indices is None
            else torch.from_numpy(subset_point_indices))
        self.register_buffer('weights', weights)
        self.register_buffer('origin', torch.as_tensor(origin, dtype=dtype))

    def forward(self, x):
        """Map ``x`` of shape ``(batch, n_features)`` forward.

        Returns ``(y, log_det_J, *extras)``: the centroid constraint is
        restored on ``y``, and ``log_det_J`` is the wrapped flow's (the
        constraint and translations contribute zero).
        """
        return self._transform(x, inverse=False)

    def inverse(self, y):
        """Invert :meth:`forward`; requires ``translate_back=True``."""
        if not self.translate_back:
            raise ValueError(
                "The inverse of CenteredCentroidFlow can be computed only if "
                "'translate_back' is set to True during both the forward and "
                "inverse transformations.")
        return self._transform(y, inverse=True)

    def _transform(self, x, inverse: bool):
        d = self.space_dimension
        batch = x.shape[0]
        x_atoms = x.reshape(batch, -1, d)

        centroid = self._compute_centroid(x_atoms)
        translate = (self.origin[None, :] - centroid)[:, None, :]
        x_flat = (x_atoms + translate).reshape(batch, -1)

        out = self._pass(x_flat, inverse=inverse)
        if self.return_partial:
            return out
        y, log_det_J = out[0], out[1]

        # Restore the centroid constraint through the fixed point.
        if self.subset_point_indices is None or \
                self.subset_point_indices.shape[0] > 1:
            y_centroid, fixed_weight = self._compute_centroid(
                y.reshape(batch, -1, d), exclude_fixed_point=True)
            fixed_value = (self.origin[None, :] - y_centroid) / fixed_weight
            y = y.index_copy(1, self.fixed_indices_buf, fixed_value)

        if self.translate_back:
            y = (y.reshape(batch, -1, d) - translate).reshape(batch, -1)

        return (y, log_det_J, *out[2:])

    def _compute_centroid(self, x_atoms, exclude_fixed_point: bool = False):
        if self.subset_point_indices is None:
            subset = x_atoms
        else:
            subset = x_atoms[:, self.subset_point_indices]

        if self.weights is None:
            centroid = torch.mean(subset, dim=1)
            fixed_weight = 1.0 / subset.shape[1]
        else:
            centroid = torch.sum(subset * self.weights[None], dim=1)
            fixed_weight = self.weights[self.fixed_point_idx, 0]

        if exclude_fixed_point:
            centroid = centroid - subset[:, self.fixed_point_idx] * fixed_weight
            return centroid, fixed_weight
        return centroid
