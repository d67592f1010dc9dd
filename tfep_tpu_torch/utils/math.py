"""Math helpers, including the brute-force Jacobian oracle used by tests.

Port of ``tfep_tpu/utils/math.py``. The oracle takes one ``jacrev``
vmapped over the batch (``torch.func``), then ``slogdet``: the same
construction as the JAX package's ``jacfwd`` + ``slogdet``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import jacrev, vmap

__all__ = [
    'batchwise_dot', 'batchwise_outer', 'cov',
    'batch_jacobian', 'batch_log_abs_det_J',
]


def batchwise_dot(x, y, keepdim: bool = False):
    """Row-wise dot product of two (batch, n) tensors."""
    out = torch.sum(x * y, dim=-1)
    if keepdim:
        out = out[..., None]
    return out


def batchwise_outer(x, y):
    """Row-wise outer product: (batch, n) x (batch, m) -> (batch, n, m)."""
    return x[..., :, None] * y[..., None, :]


def cov(x, ddof: int = 1, dim_sample: int = 0, inplace: bool = False):
    """Covariance matrix of data ``x``.

    ``dim_sample`` selects which axis indexes samples (0: rows are samples,
    like ``numpy.cov(x.T)``). ``inplace`` is accepted for the reference's
    signature and changes nothing: ``x`` is never written.
    """
    data = x if dim_sample == 0 else x.T
    centered = data - torch.mean(data, dim=0, keepdim=True)
    return centered.T @ centered / (data.shape[0] - ddof)


def batch_jacobian(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """Jacobian of a batched function, one (n_out, n_in) block per sample.

    ``fn`` maps ``(batch, n_in) -> (batch, n_out)`` with batch elements
    independent; returns shape ``(batch, n_out, n_in)``.
    """

    def single(xi):
        return fn(xi[None])[0]

    return vmap(jacrev(single))(x)


def batch_log_abs_det_J(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """log|det J| of a batched bijection: the test oracle for every flow.

    ``fn`` maps ``(batch, n) -> (batch, n)``; returns shape ``(batch,)``.
    """
    return torch.linalg.slogdet(batch_jacobian(fn, x))[1]


#: The reference's names for the oracle.
batch_autograd_jacobian = batch_jacobian
batch_autograd_log_abs_det_J = batch_log_abs_det_J

__all__ += ['batch_autograd_jacobian', 'batch_autograd_log_abs_det_J']
