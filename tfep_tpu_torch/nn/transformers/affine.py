"""Affine and volume-preserving-shift transformers.

Port of ``tfep_tpu/nn/transformers/affine.py``: ``y = exp(a) * x + b``
(affine) and ``y = x + b`` (shift, optionally wrapped into a periodic
interval). The first ``n_features`` parameters are shifts, the next
``n_features`` log-scales.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.nn.transformers.transformer import MAFTransformer

__all__ = [
    'AffineTransformer', 'VolumePreservingShiftTransformer',
    'affine_transformer', 'affine_transformer_inverse',
    'volume_preserving_shift_transformer',
    'volume_preserving_shift_transformer_inverse',
]


class AffineTransformer(MAFTransformer):
    """Affine transformer ``y_i = exp(a_i) * x_i + b_i``.

    Stateless (it holds no tensor, so it takes no device): the conditioner
    supplies the shift ``b`` followed by the log-scale ``a`` of every
    feature, ``parameters[:, :n] = shifts`` and
    ``parameters[:, n:] = log_scales``.
    """

    n_parameters_per_feature = 2

    def _split(self, parameters):
        parameters = parameters.reshape(parameters.shape[0], 2, -1)
        return parameters[:, 0], parameters[:, 1]

    def forward(self, x, parameters):
        shift, log_scale = self._split(parameters)
        return affine_transformer(x, shift, log_scale)

    def inverse(self, y, parameters):
        shift, log_scale = self._split(parameters)
        return affine_transformer_inverse(y, shift, log_scale)

    def get_identity_parameters(self, n_features: int) -> np.ndarray:
        return np.zeros(self.n_parameters_per_feature * n_features)

    def get_degrees_out(self, degrees_in: np.ndarray) -> np.ndarray:
        return np.tile(np.asarray(degrees_in), self.n_parameters_per_feature)

    def slice_features(self, feature_indices) -> 'AffineTransformer':
        """Feature-subset view (stateless: the transformer itself)."""
        return self


class VolumePreservingShiftTransformer(MAFTransformer):
    """Volume-preserving shift ``y_i = x_i + b_i`` with optional periodic wrap.

    Parameters
    ----------
    periodic_indices : array of int, optional
        Features wrapped back into ``periodic_limits`` after shifting (and
        likewise on inversion).
    periodic_limits : array, shape (2,), optional
        Lower and upper limit of the periodic interval. Required when
        ``periodic_indices`` is given.
    device : str or torch.device, optional
        Defaults to ``cuda``; raises without a card.
    dtype : torch.dtype, optional
        Type of ``periodic_limits``.
    """

    n_parameters_per_feature = 1

    def __init__(self, periodic_indices=None, periodic_limits=None,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer(
            'periodic_indices', None if periodic_indices is None else
            torch.as_tensor(np.asarray(periodic_indices), dtype=torch.long,
                            device=device))
        self.register_buffer(
            'periodic_limits', None if periodic_limits is None else
            torch.as_tensor(np.asarray(periodic_limits), dtype=dtype,
                            device=device))

    def forward(self, x, parameters):
        return volume_preserving_shift_transformer(
            x, parameters, self.periodic_indices, self.periodic_limits)

    def inverse(self, y, parameters):
        return volume_preserving_shift_transformer_inverse(
            y, parameters, self.periodic_indices, self.periodic_limits)

    def get_identity_parameters(self, n_features: int) -> np.ndarray:
        return np.zeros(self.n_parameters_per_feature * n_features)

    def get_degrees_out(self, degrees_in: np.ndarray) -> np.ndarray:
        return np.tile(np.asarray(degrees_in), self.n_parameters_per_feature)


# =============================================================================
# Functional API
# =============================================================================

def affine_transformer(x, shift, log_scale):
    """``y = exp(log_scale) * x + shift``; ``log_det_J = sum(log_scale)``."""
    y = x * torch.exp(log_scale) + shift
    return y, torch.sum(log_scale, dim=-1)


def affine_transformer_inverse(y, shift, log_scale):
    """Inverse of :func:`affine_transformer`: ``x = (y - b) * exp(-a)``."""
    x = (y - shift) * torch.exp(-log_scale)
    return x, -torch.sum(log_scale, dim=-1)


def _periodic_wrap(x, periodic_indices, periodic_limits):
    if periodic_indices is None:
        return x
    lo, hi = periodic_limits[0], periodic_limits[1]
    wrapped = (x[:, periodic_indices] - lo) % (hi - lo) + lo
    return x.index_copy(1, periodic_indices, wrapped)


def volume_preserving_shift_transformer(
        x, shift, periodic_indices: Optional[torch.Tensor] = None,
        periodic_limits: Optional[torch.Tensor] = None):
    """``y = x + shift`` (unit Jacobian), periodic features wrapped into
    ``[lo, hi)`` relative to ``lo``; ``log_det_J`` is zero."""
    y = _periodic_wrap(x + shift, periodic_indices, periodic_limits)
    return y, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)


def volume_preserving_shift_transformer_inverse(
        y, shift, periodic_indices: Optional[torch.Tensor] = None,
        periodic_limits: Optional[torch.Tensor] = None):
    """Inverse of :func:`volume_preserving_shift_transformer`."""
    x = _periodic_wrap(y - shift, periodic_indices, periodic_limits)
    return x, torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)
