"""Conditioner API for autoregressive flows.

Port of ``tfep_tpu/nn/conditioners/conditioner.py``. A conditioner maps
input features to the parameter vector consumed by a transformer:
``parameters = conditioner(x)`` with shapes
``(batch, n_features) -> (batch, n_parameters)``. ``set_output`` makes it
return a given constant, the hook of identity initialization.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ['Conditioner']


class Conditioner(nn.Module):
    """Abstract base class for conditioners."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def set_output(self, output) -> 'Conditioner':
        """Make the conditioner constantly return ``output`` (in place)."""
        raise NotImplementedError
