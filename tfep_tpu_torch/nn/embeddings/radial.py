"""Radial basis expansions: Gaussian soft one-hot + Behler-Parrinello cutoff.

Port of ``tfep_tpu/nn/embeddings/radial.py``. Means and widths are either
trained parameters or frozen buffers, and the widths are stored as log
inverse variances (``log gamma``). The JAX module always keeps a trainable
slot, of size 0 when the quantity is frozen, beside a buffer that is
``None`` when it is trained; the port registers the same leaves (a size-0
``nn.Parameter`` and a ``None`` buffer), so JAX weights load key for key.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from tfep_tpu_torch.device import resolve_device

__all__ = ['GaussianBasisExpansion', 'BehlerParrinelloRadialExpansion',
           'behler_parrinello_cosine_switching_function']


class GaussianBasisExpansion(nn.Module):
    """Soft one-hot expansion ``exp(-gamma_i (r - mu_i)^2)`` (SchNet-style).

    Parameters
    ----------
    means : array_like, shape (n_gaussians,)
        Gaussian centers.
    stds : array_like, shape (n_gaussians,)
        Gaussian standard deviations (stored as ``log(1/std^2)``).
    trainable_means, trainable_stds : bool, optional
        Whether each is a trained parameter or a frozen buffer.
    device : str or torch.device, optional
        Defaults to ``cuda``; raises without a card.
    dtype : torch.dtype, optional
    """

    def __init__(self, means, stds, trainable_means: bool = False,
                 trainable_stds: bool = False, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        means = np.asarray(means, dtype=float)
        log_gammas = np.log(1.0 / np.asarray(stds, dtype=float) ** 2)
        self.trainable_means = bool(trainable_means)
        self.trainable_stds = bool(trainable_stds)
        for name, value, trainable in (
                ('means', means, trainable_means),
                ('log_gammas', log_gammas, trainable_stds)):
            value = torch.as_tensor(value, dtype=dtype, device=device)
            empty = torch.zeros(0, dtype=dtype, device=device)
            setattr(self, f'{name}_param',
                    nn.Parameter(value if trainable else empty))
            self.register_buffer(f'{name}_buf', None if trainable else value)

    @classmethod
    def from_range(cls, n_gaussians: int, max_mean: float,
                   min_mean: float = 0.0, relative_std: float = 3.0,
                   **kwargs):
        """Equidistant Gaussians; stds = relative_std * spacing."""
        means, stds = _equidistant_means_and_stds(
            n_gaussians, max_mean, min_mean, relative_std)
        return cls(means, stds, **kwargs)

    @property
    def means(self) -> torch.Tensor:
        return self.means_param if self.trainable_means else self.means_buf

    @property
    def log_gammas(self) -> torch.Tensor:
        return (self.log_gammas_param if self.trainable_stds
                else self.log_gammas_buf)

    def forward(self, data):
        """Expand ``(batch, *)`` data to ``(batch, *, n_gaussians)``."""
        if data.shape[-1] != 1:
            data = data[..., None]
        disp = (data - self.means) ** 2
        return torch.exp(-torch.exp(self.log_gammas) * disp)


def behler_parrinello_cosine_switching_function(
        r_cutoff: float, r, force_zero_after_cutoff: bool = True):
    """``0.5 cos(pi r / rc) + 0.5``, optionally zeroed beyond the cutoff."""
    switching = 0.5 * torch.cos(math.pi / r_cutoff * r) + 0.5
    if force_zero_after_cutoff:
        switching = torch.where(r > r_cutoff, 0.0, switching)
    return switching


class BehlerParrinelloRadialExpansion(GaussianBasisExpansion):
    """Gaussian expansion times the cosine switching envelope.

    Every feature decays continuously to zero at ``r_cutoff`` (and, with
    ``force_zero_after_cutoff``, stays exactly zero beyond it): the radial
    featurizer of :class:`~tfep_tpu_torch.nn.dynamics.EGNNDynamics`.
    Parameters as :class:`GaussianBasisExpansion`, after ``r_cutoff``.
    """

    def __init__(self, r_cutoff, means, stds, trainable_means=False,
                 trainable_stds=False, force_zero_after_cutoff=True,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__(means, stds, trainable_means, trainable_stds,
                         device=device, dtype=dtype)
        self.r_cutoff = float(r_cutoff)
        self.force_zero_after_cutoff = bool(force_zero_after_cutoff)

    @classmethod
    def from_range(cls, r_cutoff, n_gaussians, max_mean, min_mean=0.0,
                   relative_std=3.0, **kwargs):
        means, stds = _equidistant_means_and_stds(
            n_gaussians, max_mean, min_mean, relative_std)
        return cls(r_cutoff, means, stds, **kwargs)

    def forward(self, distances):
        encoding = GaussianBasisExpansion.forward(self, distances)
        switching = behler_parrinello_cosine_switching_function(
            self.r_cutoff, distances, self.force_zero_after_cutoff)
        return encoding * switching[..., None]


def _equidistant_means_and_stds(n_gaussians, max_mean, min_mean,
                                relative_std):
    spacing = (max_mean - min_mean) / (n_gaussians - 1)
    means = np.linspace(min_mean, max_mean, n_gaussians)
    stds = np.full(n_gaussians, relative_std * spacing)
    return means, stds
