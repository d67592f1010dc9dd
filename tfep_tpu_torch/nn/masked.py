"""Masked linear layers for autoregressive conditioners.

Port of ``tfep_tpu/nn/masked.py``. The mask is folded into the weight at
apply time (``W_eff = where(mask, W, 0)``), so autograd masks the gradient
with no custom Function. Weight normalization runs over the masked weight,
with a zero-norm guard that keeps fully masked rows finite under autograd.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from tfep_tpu_torch.device import resolve_device

__all__ = ['create_autoregressive_mask', 'MaskedLinear']


def create_autoregressive_mask(
        degrees_in: np.ndarray,
        degrees_out: np.ndarray,
        strictly_less: bool = True,
        transpose: bool = False,
) -> np.ndarray:
    """Create the autoregressive connectivity mask between two layers.

    ``mask[i, j]`` is True when input ``i`` feeds output ``j`` (or
    transposed when ``transpose=True``). Output nodes connect to inputs of
    strictly lower degree when ``strictly_less`` (MADE output layer), else
    lower-or-equal (hidden layers).

    Parameters
    ----------
    degrees_in : ndarray of int, shape (n_in,)
        Autoregressive degree of each input node (-1 marks conditioning
        inputs every output may see).
    degrees_out : ndarray of int, shape (n_out,)
        Degree of each output node.
    strictly_less : bool, optional
        Use ``>`` (output layer) instead of ``>=`` (hidden layers).
    transpose : bool, optional
        Return the ``(n_out, n_in)`` layout of the weight matrix instead of
        ``(n_in, n_out)``.

    Returns
    -------
    mask : ndarray of bool
    """
    degrees_in = np.asarray(degrees_in)
    degrees_out = np.asarray(degrees_out)
    cmp = np.greater if strictly_less else np.greater_equal
    if transpose:
        return cmp(degrees_out[:, None], degrees_in[None, :])
    return cmp(degrees_out[None, :], degrees_in[:, None])


class MaskedLinear(nn.Module):
    """Masked dense layer ``y = x @ (M o W)^T + b``, with optional weight norm.

    With ``weight_norm=True`` the effective weight is
    ``W = g * (M o V) / ||M o V||_row`` (norm over the input axis of each
    output row); rows whose mask is entirely False give zero weights with
    finite gradients. Setting ``g = 0`` (or ``W = 0`` without weight norm)
    makes the layer output its bias, the hook of identity initialization.

    Connectivity is either an explicit bool ``mask`` of shape ``(out, in)``
    or the two degree vectors ``degrees_in``/``degrees_out`` (with
    ``strictly_less``), from which the mask is recomputed at apply time:
    O(in + out) integers are stored instead of an O(in x out) buffer.

    Parameters
    ----------
    generator : torch.Generator
        CPU generator for the Kaiming-uniform initialization (bound
        ``1/sqrt(in_features)``, as ``torch.nn.Linear``).
    in_features, out_features : int
    mask : ndarray of bool, shape (out, in), optional
    bias : bool, optional
    weight_norm : bool, optional
    device : str or torch.device, optional
        Defaults to ``cuda``; raises without a card.
    dtype : torch.dtype, optional
    compute_dtype : optional
        The JAX package's bf16 matmul policy; not ported (raises).
    degrees_in, degrees_out : ndarray of int, optional
    strictly_less : bool, optional
    """

    def __init__(self, generator: torch.Generator, in_features: int,
                 out_features: int, mask: Optional[np.ndarray] = None,
                 bias: bool = True, weight_norm: bool = False,
                 device=None, dtype: torch.dtype = torch.float32,
                 compute_dtype=None,
                 degrees_in: Optional[np.ndarray] = None,
                 degrees_out: Optional[np.ndarray] = None,
                 strictly_less: bool = False):
        super().__init__()
        if compute_dtype is not None:
            raise NotImplementedError(
                'compute_dtype (mixed-precision matmuls) is not ported yet.')
        if mask is not None and degrees_in is not None:
            raise ValueError('Pass either mask or degrees_in/degrees_out, '
                             'not both.')
        if (degrees_in is None) != (degrees_out is None):
            raise ValueError('degrees_in and degrees_out must be passed '
                             'together.')
        device = resolve_device(device)
        bound = 1.0 / np.sqrt(in_features) if in_features > 0 else 0.0

        def uniform(*shape):
            u = torch.rand(*shape, generator=generator, dtype=dtype)
            return (2.0 * bound * u - bound).to(device)

        self.weight = nn.Parameter(uniform(out_features, in_features))
        self.bias = nn.Parameter(uniform(out_features)) if bias else None
        self.strictly_less = bool(strictly_less)
        self.use_weight_norm = bool(weight_norm)
        self.register_buffer('mask', None if mask is None else torch.as_tensor(
            np.asarray(mask, dtype=bool), device=device))
        for name, degrees in (('degrees_in', degrees_in),
                              ('degrees_out', degrees_out)):
            self.register_buffer(name, None if degrees is None else
                                 torch.as_tensor(np.asarray(degrees),
                                                 dtype=torch.int32,
                                                 device=device))
        self.gain = None
        if weight_norm:
            with torch.no_grad():
                norms = torch.linalg.vector_norm(
                    self._masked(self.weight, None), dim=1, keepdim=True)
            self.gain = nn.Parameter(norms)

    @property
    def in_features(self) -> int:
        return self.weight.shape[1]

    @property
    def out_features(self) -> int:
        return self.weight.shape[0]

    def _mask_array(self, rows=None) -> Optional[torch.Tensor]:
        """The (out, in) connectivity, materialized lazily if degree-based."""
        if self.mask is not None:
            return self.mask if rows is None else self.mask[rows]
        if self.degrees_out is not None:
            d_out = self.degrees_out if rows is None else self.degrees_out[rows]
            cmp = torch.gt if self.strictly_less else torch.ge
            return cmp(d_out[:, None], self.degrees_in[None, :])
        return None

    def _masked(self, w, rows):
        mask = self._mask_array(rows)
        return w if mask is None else torch.where(mask, w, 0.0)

    def effective_weight(self, rows=None) -> torch.Tensor:
        """The masked (and normalized) weight, or only its ``rows``."""
        w = self.weight if rows is None else self.weight[rows]
        w = self._masked(w, rows)
        if self.use_weight_norm:
            # sqrt of a guarded sum of squares: a fully masked row has
            # norm 0, and the guard keeps its gradient finite (0, not NaN).
            sq = torch.sum(w * w, dim=1, keepdim=True)
            norms = torch.sqrt(torch.where(sq > 0.0, sq, 1.0))
            gain = self.gain if rows is None else self.gain[rows]
            w = gain * w / norms
        return w

    def forward(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """``x @ W_eff^T + b``, for all output rows or only ``rows``."""
        y = x @ self.effective_weight(rows).T
        if self.bias is not None:
            y = y + (self.bias if rows is None else self.bias[rows])
        return y

    def n_parameters(self) -> int:
        """Number of unmasked trainable parameters."""
        if self.mask is not None:
            n = int(self.mask.sum())
        elif self.degrees_out is not None:
            # For each output row, the number of inputs with degree < (or
            # <=) its degree, without materializing the mask.
            din = np.sort(self.degrees_in.cpu().numpy())
            dout = self.degrees_out.cpu().numpy()
            side = 'left' if self.strictly_less else 'right'
            n = int(np.searchsorted(din, dout, side=side).sum())
        else:
            n = self.weight.numel()
        if self.bias is not None:
            n += self.bias.numel()
        if self.gain is not None:
            n += self.gain.numel()
        return n

    @torch.no_grad()
    def set_output(self, output) -> 'MaskedLinear':
        """Make the layer constantly output ``output`` (identity init).

        Unlike the JAX package, which returns a modified copy, this updates
        the layer in place and returns it.
        """
        output = torch.as_tensor(output, dtype=self.weight.dtype,
                                 device=self.weight.device)
        if self.use_weight_norm:
            self.gain.zero_()
        else:
            self.weight.zero_()
        if self.bias is None:
            self.bias = nn.Parameter(output.clone())
        else:
            self.bias.copy_(output)
        return self

    def restrict_rows(self, rows):
        """A callable computing only the given output rows of the layer.

        Weight normalization is per output row, so the restricted output
        equals the corresponding rows of the full output (duplicate indices
        give duplicate outputs).
        """
        return lambda x: self.forward(x, rows)
