"""TFEP loss: KL divergence between Boltzmann distributions.

Port of ``tfep_tpu/loss.py``:
``loss = mean_i [ u_B(M(x_i)) - log|det J_M(x_i)| - u_A(x_i) ]`` in kT
units, optionally softmax-weighted by per-sample log-weights (biased
sampling) and NaN-tolerant (failed engine evaluations give NaN energies).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ['boltzmann_kl_div_loss', 'BoltzmannKLDivLoss']


def boltzmann_kl_div_loss(
        target_potentials: torch.Tensor,
        log_det_J: Optional[torch.Tensor] = None,
        log_weights: Optional[torch.Tensor] = None,
        ref_potentials: Optional[torch.Tensor] = None,
        ignore_nan: bool = False,
) -> torch.Tensor:
    """Compute the TFEP training loss (all inputs in kT units, shape (batch,)).

    Parameters
    ----------
    target_potentials : torch.Tensor, shape (batch,)
        Reduced target potentials ``u_B(M(x_i)) / kT`` of the mapped samples.
    log_det_J : torch.Tensor, shape (batch,), optional
        Log absolute determinant of the map's Jacobian at each sample,
        subtracted from the work. ``None`` means a volume-preserving map.
    log_weights : torch.Tensor, shape (batch,), optional
        Per-sample log-weights for biased sampling; the loss becomes the
        ``softmax(log_weights)``-weighted sum instead of the mean.
    ref_potentials : torch.Tensor, shape (batch,), optional
        Reduced reference potentials ``u_A(x_i) / kT``; they shift the loss
        to the KL divergence value without changing its gradients.
    ignore_nan : bool, optional
        Ignore NaN work values in the reduction (``nanmean``/``nansum``).

    Returns
    -------
    loss : torch.Tensor, shape ()
    """
    reduced_work = target_potentials
    if log_det_J is not None:
        reduced_work = reduced_work - log_det_J
    if ref_potentials is not None:
        reduced_work = reduced_work - ref_potentials

    if log_weights is not None:
        weights = torch.softmax(log_weights, dim=-1)
        if ignore_nan:
            return torch.nansum(weights * reduced_work)
        return torch.sum(weights * reduced_work)

    if ignore_nan:
        return torch.nanmean(reduced_work)
    return torch.mean(reduced_work)


class BoltzmannKLDivLoss(nn.Module):
    """Module wrapper over :func:`boltzmann_kl_div_loss`.

    Parameters
    ----------
    ignore_nan : bool, optional
        Ignore NaN work values in the batch reduction (default ``False``).
    """

    def __init__(self, ignore_nan: bool = False):
        super().__init__()
        self.ignore_nan = bool(ignore_nan)

    def forward(self, target_potentials, log_det_J=None, log_weights=None,
                ref_potentials=None):
        return boltzmann_kl_div_loss(
            target_potentials, log_det_J=log_det_J, log_weights=log_weights,
            ref_potentials=ref_potentials, ignore_nan=self.ignore_nan)
