"""Mixed transformer: dispatch disjoint feature groups to sub-transformers.

Port of ``tfep_tpu/nn/transformers/mixed.py``. The mixed internal/Cartesian
map uses it to give bonds, angles and torsions their own splines. The
conditioner's parameter vector is split by cumulative lengths, in
transformer order.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from tfep_tpu_torch.device import StaticIndices, resolve_device
from tfep_tpu_torch.nn.transformers.transformer import MAFTransformer

__all__ = ['MixedTransformer']


class MixedTransformer(MAFTransformer):
    """Apply different transformers to disjoint feature-index groups.

    Each sub-transformer sees only its features, gathered into one
    contiguous tensor, and its slice of the conditioner's parameters (laid
    out per transformer, in order; the split is each transformer's
    identity-parameter count). The log-det is the sum over groups, since
    the Jacobian is block diagonal in the partition. The outputs are
    reassembled with one concatenation and one gather through the inverse
    permutation, not with a scatter per group.

    Parameters
    ----------
    transformers : sequence of MAFTransformer
        At least two sub-transformers.
    indices : sequence of sequence of int
        For each transformer, the feature indices it transforms (disjoint
        groups).
    n_features : int, optional
        Features of the inputs. Features in no group pass through
        unchanged; without ``n_features`` the groups must cover
        ``0 .. max index``.
    device : str or torch.device, optional
        Where the gather indices live. Defaults to ``cuda``; raises without
        a card.
    """

    def __init__(self, transformers: Sequence[MAFTransformer],
                 indices: Sequence[Sequence[int]], n_features=None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        if len(transformers) < 2:
            raise ValueError(
                'The number of transformers must be greater than 1.')
        if len(transformers) != len(indices):
            raise ValueError('The number of elements in indices must equal '
                             'that in transformers.')
        self.transformers = nn.ModuleList(transformers)
        self.indices = tuple(tuple(int(i) for i in np.asarray(ind).reshape(-1))
                             for ind in indices)
        self.param_lengths = tuple(
            len(t.get_identity_parameters(len(ind)))
            for t, ind in zip(transformers, self.indices))
        covered = np.concatenate([np.asarray(ind, dtype=np.int64)
                                  for ind in self.indices])
        if n_features is None:
            n_features = int(covered.max()) + 1 if len(covered) else 0
        self.n_features = int(n_features)
        rest = np.setdiff1d(np.arange(self.n_features), covered)
        self.columns = StaticIndices(
            device, groups=self.indices, rest=rest,
            order=np.argsort(np.concatenate([covered, rest])))

    # ------------------------------------------------------------------ #
    def forward(self, x, parameters):
        return self._run(x, parameters, inverse=False)

    def inverse(self, y, parameters):
        return self._run(y, parameters, inverse=True)

    def get_identity_parameters(self, n_features: int) -> np.ndarray:
        return np.concatenate([
            np.asarray(t.get_identity_parameters(len(ind)))
            for t, ind in zip(self.transformers, self.indices)])

    def get_degrees_out(self, degrees_in: np.ndarray) -> np.ndarray:
        degrees_in = np.asarray(degrees_in)
        return np.concatenate([
            np.asarray(t.get_degrees_out(degrees_in[np.asarray(ind)]))
            for t, ind in zip(self.transformers, self.indices)])

    def _run(self, x, parameters, inverse: bool):
        if x.shape[1] != self.n_features:
            raise ValueError(f'MixedTransformer was built for '
                             f'{self.n_features} features, got {x.shape[1]}.')
        parts = []
        log_det_J = 0.0
        # Views of the parameters' columns, one a group, which the spline
        # kernels read in place; their gradients come back as one
        # concatenation.
        group_parameters = torch.split(parameters, self.param_lengths, dim=1)
        for transformer, ind, group_params in zip(self.transformers,
                                                  self.columns['groups'],
                                                  group_parameters):
            fn = transformer.inverse if inverse else transformer.forward
            y_part, ldj = fn(x.index_select(1, ind), group_params)
            parts.append(y_part)
            log_det_J = log_det_J + ldj
        rest = self.columns['rest']
        if rest.shape[0]:
            parts.append(x.index_select(1, rest))
        y = torch.cat(parts, dim=1).index_select(1, self.columns['order'])
        return y, log_det_J
