"""Sequential composition of flows with cumulative log-det-Jacobian.

Port of ``tfep_tpu/nn/flows/sequential.py``, including the accumulation of
optional regularization terms (a third output of continuous flows).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.nn.flows.flow import Flow

__all__ = ['SequentialFlow']


class SequentialFlow(Flow):
    """A sequence of flows executed in order (reversed for the inverse).

    With ``remat=True`` each layer runs under ``torch.utils.checkpoint``,
    so the backward pass saves only the per-layer inputs and recomputes
    every intermediate activation.

    Parameters
    ----------
    flows : sequence of Flow
        Applied in order by :meth:`forward` and in reverse by
        :meth:`inverse`; log-det-Jacobians accumulate, and any third
        (regularization) outputs are summed.
    remat : bool, optional
        Recompute each layer in the backward pass (default ``False``).
    """

    def __init__(self, flows, remat: bool = False):
        super().__init__()
        self.flows = nn.ModuleList(flows)
        self.remat = bool(remat)

    @classmethod
    def create(cls, *flows, remat: bool = False,
               device=None) -> 'SequentialFlow':
        """Compose ``flows`` and move them to ``device``.

        ``device`` defaults to ``cuda`` and raises without a card.
        """
        return cls(flows, remat=remat).to(resolve_device(device))

    def __getitem__(self, i):
        return self.flows[i]

    def __len__(self):
        return len(self.flows)

    def n_parameters(self) -> int:
        return sum(f.n_parameters() for f in self.flows)

    def forward(self, x):
        return self._pass(x, inverse=False)

    def inverse(self, y):
        return self._pass(y, inverse=True)

    def _pass(self, x, inverse: bool):
        cumulative_log_det_J = torch.zeros(x.shape[0], dtype=x.dtype,
                                           device=x.device)
        regularization = None

        flows = reversed(self.flows) if inverse else self.flows
        for flow in flows:
            apply = flow.inverse if inverse else flow.forward
            if self.remat:
                out = checkpoint(apply, x, use_reentrant=False)
            else:
                out = apply(x)
            x, log_det_J = out[0], out[1]
            cumulative_log_det_J = cumulative_log_det_J + log_det_J
            if len(out) > 2 and out[2] is not None:
                regularization = (out[2] if regularization is None
                                  else regularization + out[2])

        if regularization is None:
            return x, cumulative_log_det_J
        return x, cumulative_log_det_J, regularization
