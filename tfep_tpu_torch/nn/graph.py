"""Graph primitives for molecular graph networks.

Port of ``tfep_tpu/nn/graph.py``. Cutoff "pruning" is a mask, as in the JAX
package (the edge count stays fixed and pruned edges are zero-weighted),
so shapes do not depend on the data. The edge-list helpers are kept for
parity; the EGNN dynamics uses a dense all-pairs formulation instead.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tfep_tpu_torch.device import resolve_device

__all__ = ['FixedGraph', 'get_all_edges', 'fix_node_indices_batch_size',
           'compute_edge_distances', 'prune_long_edges',
           'unsorted_segment_sum']


def get_all_edges(n_nodes: int) -> np.ndarray:
    """All directed edges of a complete graph (no self loops), shape (2, E).

    Host-side, used when a model is built.
    """
    src, dest = np.meshgrid(np.arange(n_nodes), np.arange(n_nodes),
                            indexing='ij')
    mask = src != dest
    return np.stack([src[mask], dest[mask]])


def fix_node_indices_batch_size(edges: np.ndarray, batch_size: int,
                                n_nodes: int) -> np.ndarray:
    """Tile single-graph edges into a batch-flattened disconnected graph.

    Node ``i`` of batch sample ``b`` becomes node ``b*n_nodes + i``; no edges
    cross samples.
    """
    offsets = (np.arange(batch_size) * n_nodes)[None, None, :]
    return (np.asarray(edges)[:, :, None] + offsets).reshape(2, -1)


def compute_edge_distances(x: torch.Tensor, edges,
                           normalize_directions: bool = True):
    """Distances (and direction vectors dest-src) for an edge list.

    ``x``: (n_total_nodes, 3); ``edges``: (2, n_edges). Directions point
    src -> dest (``x[edges[1]] - x[edges[0]]``).
    """
    edges = torch.as_tensor(edges, device=x.device)
    diff = x[edges[1]] - x[edges[0]]
    distances = torch.linalg.norm(diff, dim=-1)
    if normalize_directions:
        safe = torch.where(distances > 0, distances,
                           torch.ones_like(distances))
        diff = diff / safe[:, None]
    return distances, diff


def prune_long_edges(r_cutoff: float, edges, distances, directions=None):
    """Mask edges beyond the cutoff (fixed shapes: a mask, not removal).

    Returns ``(mask, edges, distances, directions)`` where ``mask`` is a
    boolean (n_edges,) tensor; callers weight contributions by it.
    """
    mask = distances <= r_cutoff
    return mask, edges, distances, directions


def unsorted_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                         n_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``n_segments`` buckets (message aggregation),
    out of place."""
    segment_ids = torch.as_tensor(segment_ids, device=data.device)
    out = torch.zeros((n_segments, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, segment_ids, data)


class FixedGraph(nn.Module):
    """Base class for networks over a fixed molecular graph.

    Holds one-hot node-type features and the complete edge list (built on
    the host); batched graphs are the standard disconnected-union layout.
    Buffers, with the JAX package's names: ``node_types_one_hot``
    ``(n_nodes, n_types)`` and ``edges_template`` ``(2, E)``.
    """

    def __init__(self, node_types_one_hot=None, edges_template=None,
                 n_nodes: int = 0, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer('node_types_one_hot', None if node_types_one_hot
                             is None else torch.as_tensor(
                                 node_types_one_hot, dtype=dtype,
                                 device=device))
        self.register_buffer('edges_template', None if edges_template is None
                             else torch.as_tensor(np.asarray(edges_template),
                                                  device=device))
        self.n_nodes = int(n_nodes)

    @staticmethod
    def build_node_features(node_types) -> np.ndarray:
        node_types = np.asarray(node_types)
        n_types = int(node_types.max()) + 1
        return np.eye(n_types)[node_types]

    def get_edges(self, batch_size: int) -> torch.Tensor:
        """Batch-flattened edges, shape (2, batch_size * E)."""
        offsets = (torch.arange(batch_size, device=self.edges_template.device)
                   * self.n_nodes)[None, None, :]
        return (self.edges_template[:, :, None] + offsets).reshape(2, -1)
