"""Flow base class: the invertible-map contract.

Port of ``tfep_tpu/nn/flows/flow.py``. Every flow implements

    ``forward(x) -> (y, log_det_J)`` and ``inverse(y) -> (x, log_det_J)``

with ``x``/``y`` of shape ``(batch, n_features)`` and ``log_det_J`` of
shape ``(batch,)``.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ['Flow', 'default_float']


def default_float() -> torch.dtype:
    """Canonical float dtype: torch's default (float32 unless changed with
    ``torch.set_default_dtype``)."""
    return torch.get_default_dtype()


class Flow(nn.Module):
    """Abstract base class for invertible maps.

    Subclasses implement :meth:`forward` and :meth:`inverse`, both mapping
    a ``(batch, n_features)`` tensor to ``(output, log_det_J)`` with
    ``forward_log_det_J(x) + inverse_log_det_J(forward(x)) == 0``. Calling
    the module runs :meth:`forward`, the training direction.
    """

    def forward(self, x):
        """Map ``x`` to ``(y, log_det_J)``."""
        raise NotImplementedError

    def inverse(self, y):
        """Exact inverse of :meth:`forward`; returns ``(x, log_det_J)``."""
        raise NotImplementedError
