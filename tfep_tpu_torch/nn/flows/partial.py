"""Partial flow: maps only a subset of the degrees of freedom.

Port of ``tfep_tpu/nn/flows/partial.py``. The wrapped flow never sees the
fixed DOFs (they cannot condition it); the output re-inserts them
unchanged. Indices are resolved on the host when the flow is built, and the
output is a new tensor: the caller's input is never written.
"""

from __future__ import annotations

import numpy as np
import torch

from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.nn.flows.flow import Flow

__all__ = ['PartialFlow']


class PartialFlow(Flow):
    """Wrap a flow so that ``fixed_indices`` DOFs are held constant.

    Parameters
    ----------
    flow : Flow
        The wrapped flow; it sees only the propagated (non-fixed) features.
    fixed_indices : array-like of int
        Fixed feature indices (held constant, never conditioning).
    n_features : int
        Total number of features of the input.
    return_partial : bool, optional
        If ``True``, return only the propagated features (without
        re-inserting the fixed ones), as the wrapped flow returns them.

    Notes
    -----
    Build with :meth:`create`, which also moves the flow to its device.
    The fixed DOFs contribute nothing to ``log_det_J`` (identity block).
    Keyword arguments of :meth:`forward` and :meth:`inverse` go to the
    wrapped flow. The index sets are the integer buffers
    ``fixed_indices_buf`` (sorted) and ``propagated_indices`` (its
    complement), named as the JAX module's leaves.
    """

    def __init__(self, flow, fixed_indices, n_features: int,
                 return_partial: bool = False):
        super().__init__()
        self.flow = flow
        fixed = np.sort(np.asarray(fixed_indices, dtype=np.int64).reshape(-1))
        self.register_buffer('fixed_indices_buf', torch.from_numpy(fixed))
        self.register_buffer('propagated_indices', torch.from_numpy(
            np.setdiff1d(np.arange(n_features), fixed)))
        self.return_partial = bool(return_partial)

    @classmethod
    def create(cls, flow, *args, device=None, **kwargs):
        """Build the flow from the class's arguments on ``device``, which
        defaults to ``cuda`` and raises without a card."""
        device = resolve_device(device)
        return cls(flow, *args, **kwargs).to(device)

    @property
    def fixed_indices(self):
        return self.fixed_indices_buf

    def n_parameters(self) -> int:
        return self.flow.n_parameters()

    def forward(self, x, **kwargs):
        return self._pass(x, inverse=False, **kwargs)

    def inverse(self, y, **kwargs):
        return self._pass(y, inverse=True, **kwargs)

    def _pass(self, x, inverse: bool, **kwargs):
        has_fixed = self.fixed_indices_buf.shape[0] > 0
        x_full = x
        if has_fixed:
            x = x.index_select(1, self.propagated_indices)

        out = (self.flow.inverse(x, **kwargs) if inverse
               else self.flow.forward(x, **kwargs))

        if self.return_partial:
            return out

        if has_fixed:
            y = x_full.index_copy(1, self.propagated_indices, out[0])
        else:
            y = out[0]
        return (y, *out[1:])
