"""Transformer API for autoregressive flows.

Port of ``tfep_tpu/nn/transformers/transformer.py``. A transformer applies a
parametric bijection elementwise over features:
``forward(x, parameters) -> (y, log_det_J)`` with ``x`` of shape
``(batch, n_features)`` and ``parameters`` of shape
``(batch, n_parameters)``. ``get_identity_parameters`` returns the numpy
parameter vector that makes the map the identity; ``get_degrees_out`` lifts
feature degrees to parameter degrees so a MADE conditioner preserves the
autoregressive property.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ['Transformer', 'MAFTransformer']


class Transformer(nn.Module):
    """Abstract base class for transformers.

    Subclasses implement :meth:`forward`, :meth:`inverse` (both returning
    ``(output, log_det_J)``) and :meth:`get_identity_parameters`.
    """

    def forward(self, x: torch.Tensor, parameters: torch.Tensor):
        """Map ``x`` with per-sample ``parameters``; returns
        ``(y, log_det_J)`` with ``log_det_J`` of shape ``(batch,)``."""
        raise NotImplementedError

    def inverse(self, y: torch.Tensor, parameters: torch.Tensor):
        """Exact inverse of :meth:`forward`; returns ``(x, -log_det_J)``."""
        raise NotImplementedError

    def get_identity_parameters(self, n_features: int) -> np.ndarray:
        """Parameter vector (numpy) making this the identity map."""
        raise NotImplementedError


class MAFTransformer(Transformer):
    """A transformer usable inside a MAF (adds conditioner degree mapping).

    Transformers whose parameters follow the tiled layout
    ``(batch, n_parameters_per_feature, n_features)`` may implement
    ``slice_features(indices) -> transformer``, a view over a feature
    subset; the autoregressive inverse then evaluates only the current
    degree group's features per iteration.
    """

    def get_degrees_out(self, degrees_in: np.ndarray) -> np.ndarray:
        """Degrees of each conditioner output parameter (numpy)."""
        raise NotImplementedError
