"""MAF input embeddings: periodic (cos/sin), flip-invariant, and mixed.

Port of ``tfep_tpu/nn/embeddings/mafembed.py``. An embedding lifts the
conditioner's inputs to a better representation and lifts the feature
degrees alongside (``get_degrees_out``), so the MADE masks stay
autoregressive. Output layout: the non-embedded features first, then the
embedded blocks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from tfep_tpu_torch.device import StaticIndices, resolve_device
from tfep_tpu_torch.nn.masked import MaskedLinear
from tfep_tpu_torch.utils.misc import remove_and_shift_sorted_indices

__all__ = ['MAFEmbedding', 'PeriodicEmbedding', 'FlipInvariantEmbedding',
           'MixedEmbedding']


def _index(indices, device):
    return torch.as_tensor(np.asarray(indices, dtype=np.int64), device=device)


def _unique_indices(indices, n_features_in: int, name: str) -> np.ndarray:
    if indices is None:
        return np.arange(n_features_in)
    indices = np.asarray(indices)
    if len(np.unique(indices)) < len(indices):
        raise ValueError(f'Found duplicated indices in {name}.')
    return indices


class MAFEmbedding(nn.Module):
    """Base class of the MAF conditioner's input embeddings.

    Implementations map ``(batch, n_features_in)`` to ``(batch,
    n_features_out)`` and implement :meth:`get_degrees_out`, so the MADE
    conditioner can give each output feature the degree of the input it
    derives from.
    """

    def get_degrees_out(self, degrees_in: np.ndarray) -> np.ndarray:
        """``(n_features_out,)`` degrees of the embedding's outputs, in its
        output order, from the ``(n_features_in,)`` input degrees."""
        raise NotImplementedError


class PeriodicEmbedding(MAFEmbedding):
    """Lift periodic DOFs to (cos, sin) pairs.

    Each periodic feature is rescaled so ``limits`` spans one period and
    emitted as its (cos, sin) pair, which removes the discontinuity at the
    period's boundary. Output layout: ``[x[nonperiodic], cos/sin
    interleaved per periodic DOF]``.

    Parameters
    ----------
    n_features_in : int
        Total input features.
    limits : sequence of 2 floats
        Values identified with each other (one period).
    periodic_indices : sequence of int, optional
        Which features are periodic (default: all).
    device : str or torch.device, optional
        Defaults to ``cuda``; raises without a card.
    dtype : torch.dtype, optional
        Type of ``limits``.

    Buffers, with the JAX package's names: ``limits``,
    ``periodic_indices``, ``nonperiodic_indices``.
    """

    def __init__(self, n_features_in: int, limits: Sequence[float],
                 periodic_indices: Optional[Sequence[int]] = None,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        periodic = _unique_indices(periodic_indices, n_features_in,
                                   'periodic_indices')
        nonperiodic = remove_and_shift_sorted_indices(
            np.arange(n_features_in), np.sort(periodic), shift=False)
        self.register_buffer('limits', torch.as_tensor(
            np.asarray(limits, dtype=float), dtype=dtype, device=device))
        self.register_buffer('periodic_indices', _index(periodic, device))
        self.register_buffer('nonperiodic_indices',
                             _index(nonperiodic, device))

    def forward(self, x):
        period_scale = 2 * torch.pi / (self.limits[1] - self.limits[0])
        x_periodic = (x[:, self.periodic_indices] - self.limits[0]) \
            * period_scale
        cos_sin = torch.stack([torch.cos(x_periodic), torch.sin(x_periodic)],
                              dim=2).reshape(x.shape[0], -1)
        return torch.cat([x[:, self.nonperiodic_indices], cos_sin], dim=1)

    def get_degrees_out(self, degrees_in: np.ndarray) -> np.ndarray:
        degrees_in = np.asarray(degrees_in)
        return np.concatenate([
            degrees_in[self.nonperiodic_indices.cpu().numpy()],
            np.repeat(degrees_in[self.periodic_indices.cpu().numpy()], 2),
        ])


class FlipInvariantEmbedding(MAFEmbedding):
    """Sign-flip-invariant vector embedding (Köhler et al., SI Eq. 46).

    Each ``vector_dimension``-vector ``v`` maps to a softmax-weighted mix
    of ``MLP(v)`` and ``MLP(-v)`` (weights from a second MLP), so
    ``E(v) == E(-v)`` exactly: quaternions ``q`` and ``-q`` encode the
    same rotation. All components of a vector must share one degree, which
    its ``embedding_dimension`` outputs inherit.

    Parameters
    ----------
    generator : torch.Generator
        CPU generator for the two MLPs' initialization.
    n_features_in : int
        Total input features.
    embedding_dimension : int
        Output features per embedded vector.
    embedded_indices : sequence of int, optional
        Features forming the embedded vectors, in groups of
        ``vector_dimension`` consecutive indices (default: all).
    vector_dimension : int, optional
        Components per vector (4 for quaternions).
    hidden_layer_width : int, optional
        Width of the MLPs' single hidden layer.
    device, dtype : optional
        As :class:`~tfep_tpu_torch.nn.masked.MaskedLinear`.
    """

    def __init__(self, generator: torch.Generator, n_features_in: int,
                 embedding_dimension: int,
                 embedded_indices: Optional[Sequence[int]] = None,
                 vector_dimension: int = 4, hidden_layer_width: int = 32,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        embedded = _unique_indices(embedded_indices, n_features_in,
                                   'embedded_indices')
        nonembedded = remove_and_shift_sorted_indices(
            np.arange(n_features_in), np.sort(embedded), shift=False)

        def linear(d_in, d_out):
            return MaskedLinear(generator, d_in, d_out, device=device,
                                dtype=dtype)

        self.embed_l1 = linear(vector_dimension, hidden_layer_width)
        self.embed_l2 = linear(hidden_layer_width, embedding_dimension)
        self.weight_l1 = linear(vector_dimension, hidden_layer_width)
        self.weight_l2 = linear(hidden_layer_width, 1)
        self.register_buffer('embedded_indices', _index(embedded, device))
        self.register_buffer('nonembedded_indices',
                             _index(nonembedded, device))
        self.vector_dimension = int(vector_dimension)
        self.embedding_dimension = int(embedding_dimension)

    def _embed(self, v):
        return self.embed_l2(torch.nn.functional.elu(self.embed_l1(v)))

    def _weight(self, v):
        return self.weight_l2(torch.nn.functional.elu(self.weight_l1(v)))

    def forward(self, x):
        batch_size = x.shape[0]
        vectors = x[:, self.embedded_indices].reshape(
            -1, self.vector_dimension)
        embedded = torch.stack([self._embed(vectors), self._embed(-vectors)],
                               dim=1)
        weights = torch.softmax(
            torch.stack([self._weight(vectors), self._weight(-vectors)],
                        dim=1), dim=1)
        embedded = torch.sum(weights * embedded, dim=1).reshape(batch_size,
                                                                 -1)
        return torch.cat([x[:, self.nonembedded_indices], embedded], dim=1)

    def get_degrees_out(self, degrees_in: np.ndarray) -> np.ndarray:
        degrees_in = np.asarray(degrees_in)
        vec_degrees = degrees_in[self.embedded_indices.cpu().numpy()].reshape(
            -1, self.vector_dimension)
        if not np.all(vec_degrees == vec_degrees[:, [0]]):
            raise ValueError('The same degree must be assigned to all '
                             'components of each embedded vectors.')
        vec_degrees = np.repeat(vec_degrees[:, 0], self.embedding_dimension)
        return np.concatenate([
            degrees_in[self.nonembedded_indices.cpu().numpy()], vec_degrees])


class MixedEmbedding(MAFEmbedding):
    """Compose several embeddings over disjoint feature groups.

    Each sub-embedding receives its assigned input columns (and must be
    built for that many features); features assigned to no embedding pass
    through unchanged. Output layout: the non-embedded features first,
    then each embedding's output in layer order.

    Parameters
    ----------
    n_features_in : int
        Total input features.
    embedding_layers : sequence of MAFEmbedding
        The sub-embeddings.
    embedded_indices : sequence of sequence of int
        For each sub-embedding, the (disjoint) input features it receives.
    device : str or torch.device, optional
        Defaults to ``cuda``; raises without a card.

    Buffers, with the JAX package's names: ``nonembedded_indices``. Each
    layer's own columns are fixed structure, as in the JAX package.
    """

    def __init__(self, n_features_in: int,
                 embedding_layers: Sequence[MAFEmbedding],
                 embedded_indices: Sequence[Sequence[int]], device=None):
        super().__init__()
        device = resolve_device(device)
        if len(embedding_layers) != len(embedded_indices):
            raise ValueError('Different number of layers and indices.')
        embedded_indices = [np.asarray(ind).reshape(-1)
                            for ind in embedded_indices]
        seen = set(embedded_indices[0].tolist())
        for ind in embedded_indices[1:]:
            if seen & set(ind.tolist()):
                raise ValueError('Different embedding layers must be '
                                 'assigned to different feature indices.')
            seen |= set(ind.tolist())
        nonembedded = remove_and_shift_sorted_indices(
            np.arange(n_features_in),
            np.sort(np.concatenate(embedded_indices)), shift=False)
        self.embedding_layers = nn.ModuleList(embedding_layers)
        self.embedded_indices = tuple(tuple(int(i) for i in ind)
                                      for ind in embedded_indices)
        self.register_buffer('nonembedded_indices',
                             _index(nonembedded, device))
        self.columns = StaticIndices(device, layers=tuple(
            self.embedded_indices))

    def forward(self, x):
        parts = [x[:, self.nonembedded_indices]]
        for layer, ind in zip(self.embedding_layers,
                              self.columns['layers']):
            parts.append(layer(x[:, ind]))
        return torch.cat(parts, dim=1)

    def get_degrees_out(self, degrees_in: np.ndarray) -> np.ndarray:
        degrees_in = np.asarray(degrees_in)
        parts = [degrees_in[self.nonembedded_indices.cpu().numpy()]]
        for layer, ind in zip(self.embedding_layers, self.embedded_indices):
            parts.append(np.asarray(
                layer.get_degrees_out(degrees_in[np.asarray(ind)])))
        return np.concatenate(parts)
