"""MADE: masked autoregressive conditioner network.

Port of ``tfep_tpu/nn/conditioners/made.py``. Degree bookkeeping is
host-side numpy, kept here as the port's own copy; the forward pass is a
stack of masked matmuls (cuBLAS through ``torch.matmul``) and ELUs.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Optional, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.nn.conditioners.conditioner import Conditioner
from tfep_tpu_torch.nn.masked import MaskedLinear

__all__ = ['MADE', 'generate_degrees']


def generate_degrees(
        n_features: int,
        order: str = 'ascending',
        max_value: Optional[int] = None,
        conditioning_indices: Optional[Sequence[int]] = None,
        repeats: Union[int, Sequence[int]] = 1,
        seed: Optional[int] = None,
) -> np.ndarray:
    """Generate MADE node degrees 0..max_value, with -1 at conditioning slots.

    Parameters
    ----------
    n_features : int
        Total number of nodes (including conditioning slots).
    order : {'ascending', 'descending', 'random'}, optional
        Direction of the degree ramp.
    max_value : int, optional
        Highest degree; defaults so each degree appears once (after
        ``repeats``). Degrees repeat round-robin when ``n_features``
        exceeds the ramp length.
    conditioning_indices : sequence of int, optional
        Slots assigned degree -1 (visible to every output).
    repeats : int or sequence of int, optional
        How many consecutive nodes share each degree.
    seed : int, optional
        RNG seed for ``order='random'``.

    Returns
    -------
    degrees : ndarray of int, shape (n_features,)

    Examples
    --------
    >>> generate_degrees(n_features=3).tolist()
    [0, 1, 2]
    >>> generate_degrees(7, order='descending', max_value=2).tolist()
    [2, 1, 0, 2, 1, 0, 2]
    >>> generate_degrees(7, max_value=2, conditioning_indices=[0, 2, 3]).tolist()
    [-1, 0, -1, -1, 1, 2, 0]
    >>> generate_degrees(6, repeats=2).tolist()
    [0, 0, 1, 1, 2, 2]
    >>> generate_degrees(7, repeats=[1, 3, 2], conditioning_indices=[2]).tolist()
    [0, 1, -1, 1, 1, 2, 2]
    """
    n_nonconditioning = n_features
    if conditioning_indices is not None:
        conditioning_indices = list(np.asarray(conditioning_indices).tolist())
        n_nonconditioning -= len(conditioning_indices)

    if max_value is None:
        if np.ndim(repeats) > 0:
            max_value = len(repeats) - 1
        else:
            max_value = int(np.ceil(n_nonconditioning / repeats)) - 1

    if order == 'ascending':
        degrees = np.arange(max_value + 1)
    elif order == 'descending':
        degrees = np.arange(max_value, -1, -1)
    elif order == 'random':
        degrees = np.random.default_rng(seed).permutation(max_value + 1)
    else:
        raise ValueError("order must be 'ascending', 'descending', or 'random'")

    degrees = np.repeat(degrees, repeats)[:n_nonconditioning]
    degrees = _round_robin(degrees, n_nonconditioning)

    if conditioning_indices is not None:
        cond_set = set(conditioning_indices)
        noncond = [i for i in range(n_features) if i not in cond_set]
        out = np.empty(n_features, dtype=degrees.dtype)
        out[conditioning_indices] = -1
        out[noncond] = degrees
        degrees = out
    return degrees


def _round_robin(x: np.ndarray, length: int,
                 err_msg: Optional[str] = None) -> np.ndarray:
    """Tile 1D ``x`` round-robin to exactly ``length`` elements."""
    n_full, n_rem = divmod(length, len(x))
    if n_full == 0:
        raise ValueError(
            err_msg or f'Length {length} is smaller than the array '
                       f'(len={len(x)}).')
    out = np.tile(x, n_full)
    if n_rem:
        out = np.concatenate([out, x[:n_rem]])
    return out


class MADE(Conditioner):
    """Masked autoregressive conditioner, optionally with an input embedding.

    An output node of degree ``d`` depends only on inputs with degree
    strictly less than ``d``; hidden nodes connect with less-or-equal
    degrees. Hidden-layer degrees are assigned round-robin from the
    relevant input degrees. If ``embedding`` is given, the input is first
    lifted by it and ``degrees_in`` refers to the embedded input.

    Parameters
    ----------
    generator : torch.Generator
        CPU generator for the weight initialization.
    degrees_in : ndarray of int
        Degree of each (embedded) input node; -1 marks conditioning.
    degrees_out : ndarray of int
        Degree of each output parameter (the transformer's
        ``get_degrees_out``).
    hidden_layers : int or sequence, optional
        Number of hidden layers (widths chosen automatically), a list of
        widths, or a list of explicit per-layer degree arrays.
    weight_norm : bool, optional
    embedding : nn.Module, optional
    device, dtype, compute_dtype : optional
        As :class:`MaskedLinear`.
    """

    def __init__(self, generator: torch.Generator, degrees_in, degrees_out,
                 hidden_layers: Union[int, Sequence] = 2,
                 weight_norm: bool = True, embedding=None, device=None,
                 dtype: torch.dtype = torch.float32, compute_dtype=None):
        super().__init__()
        device = resolve_device(device)
        degrees_in = np.asarray(degrees_in)
        degrees_out = np.asarray(degrees_out)
        degrees_hidden = self._get_degrees_hidden(
            degrees_in, degrees_out, hidden_layers)

        layers = []
        degrees_prev = degrees_in
        all_layer_degrees = list(degrees_hidden) + [degrees_out]
        for layer_idx, degrees_cur in enumerate(all_layer_degrees):
            layers.append(MaskedLinear(
                generator, in_features=len(degrees_prev),
                out_features=len(degrees_cur), bias=True,
                weight_norm=weight_norm, device=device, dtype=dtype,
                compute_dtype=compute_dtype,
                degrees_in=degrees_prev, degrees_out=degrees_cur,
                strictly_less=layer_idx == len(all_layer_degrees) - 1))
            degrees_prev = degrees_cur
        self.layers = nn.ModuleList(layers)
        self.embedding = embedding
        self.degrees_in_list = tuple(degrees_in.tolist())
        self.degrees_out_list = tuple(degrees_out.tolist())

    @staticmethod
    def _get_degrees_hidden(degrees_in, degrees_out, hidden_layers):
        """Degrees of the hidden-layer nodes."""
        max_degree_out = degrees_out.max()
        relevant_mask = degrees_in < max_degree_out

        if isinstance(hidden_layers, (int, np.integer)):
            n_relevant = int(relevant_mask.sum())
            n_nodes = int(np.ceil((n_relevant * len(degrees_out)) ** 0.5))
            n_nodes = max(n_nodes, n_relevant)
            hidden_layers = [n_nodes] * int(hidden_layers)

        hidden_layers = list(hidden_layers)
        if len(hidden_layers) == 0:
            return []
        if isinstance(hidden_layers[0], (int, np.integer)):
            motif = degrees_in[relevant_mask]
            return [_round_robin(
                motif, width,
                err_msg=(f'Hidden layer {layer_idx} is too small for the '
                         'number of input features. Increase the size of '
                         'the layer or explicitly pass the degrees.'))
                for layer_idx, width in enumerate(hidden_layers)]

        degrees_hidden = [np.asarray(d) for d in hidden_layers]
        for layer_idx, degrees in enumerate(degrees_hidden):
            if np.any(degrees >= max_degree_out):
                raise ValueError(
                    f'The {layer_idx}-th hidden layer contains nodes with '
                    'degrees that will be ignored by the output layer.')
        return degrees_hidden

    @property
    def dimension_in(self) -> int:
        """Input features (after the embedding, if any)."""
        return self.layers[0].in_features

    @property
    def dimension_out(self) -> int:
        """Output features (the transformer's parameters per sample)."""
        return self.layers[-1].out_features

    @property
    def dimensions_hidden(self) -> list:
        """Widths of the hidden layers."""
        return [layer.out_features for layer in self.layers[:-1]]

    def n_parameters(self) -> int:
        """Total trainable parameter count."""
        return sum(layer.n_parameters() for layer in self.layers)

    def _hidden(self, x):
        if self.embedding is not None:
            x = self.embedding(x)
        for layer in self.layers[:-1]:
            x = F.elu(layer(x))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers[-1](self._hidden(x))

    def set_output(self, output) -> 'MADE':
        """Make the output the constant ``output`` (zeroed final weights,
        bias set), in place."""
        self.layers[-1].set_output(output)
        return self

    def forward_rows(self, x: torch.Tensor, rows) -> torch.Tensor:
        """Compute only the given output rows (hidden layers run in full).

        The same math as ``self(x)[:, rows]``; the final (largest) matmul is
        restricted to ``rows``. This powers the fast autoregressive inverse,
        where each iteration needs one degree group's parameters.
        """
        return self.layers[-1](self._hidden(x), rows)
