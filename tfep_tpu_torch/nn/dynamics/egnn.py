"""E(n)-equivariant GNN velocity field for continuous normalizing flows.

Port of ``tfep_tpu/nn/dynamics/egnn.py``: messages over all atom pairs
``(batch, n, n, feat)``, the radial cutoff as a Behler-Parrinello envelope
times a hard mask, node features from one-hot types and the Gaussian-
embedded time, sigmoid attention, tanh-bounded displacements along unit
directions, residual feature updates, and the velocity with its mean
removed. The first weight of the message MLP keeps the sender-first block
order ``[h_j, h_i, emb]``, so JAX weights load as they are.

``pairwise='dense'`` (the default) computes the pairwise block in plain
PyTorch; ``'fused'`` runs it through the CUDA kernels of
:mod:`tfep_tpu_torch.ops.egnn` (their plain version on the CPU). The
fused block's gradient exists only through :meth:`forward_and_jvp`, the
pattern of the CNF's Hutchinson trace: primal and tangent in one K4
launch, and K5 backward. A plain call on the fused path launches K3 and
has no gradient, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.nn.embeddings.radial import (
    BehlerParrinelloRadialExpansion, GaussianBasisExpansion,
)
from tfep_tpu_torch.nn.masked import MaskedLinear, low_precision_matmul
from tfep_tpu_torch.ops.egnn import egnn_pairwise, egnn_pairwise_jvp

__all__ = ['EGNNDynamics']

_PAIRWISE = ('dense', 'fused')


class _MLP(nn.Module):
    """Small dense MLP with SiLU activations (optionally on the output)."""

    def __init__(self, generator, dims, final_activation='none',
                 bias_last=True, device=None, dtype=torch.float32,
                 compute_dtype=None):
        super().__init__()
        n_layers = len(dims) - 1
        self.layers = nn.ModuleList(
            MaskedLinear(generator, d_in, d_out,
                         bias=bias_last if i == n_layers - 1 else True,
                         device=device, dtype=dtype,
                         compute_dtype=compute_dtype)
            for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])))
        self.final_activation = final_activation

    def forward(self, x):
        return self.finish(self.layers[0](x))

    def finish(self, x):
        """Everything after the first linear layer (callers that compute
        the first layer in factored form feed its pre-activation here)."""
        for layer in self.layers[1:]:
            x = layer(torch.nn.functional.silu(x))
        if self.final_activation == 'silu':
            x = torch.nn.functional.silu(x)
        elif self.final_activation == 'tanh':
            x = torch.tanh(x)
        elif self.final_activation == 'sigmoid':
            x = torch.sigmoid(x)
        return x


def _geometry(pos):
    """Safe pairwise distances (diagonal 1) and unit directions, receiver
    ``i``, sender ``j``."""
    n = pos.shape[1]
    diff = pos[:, :, None, :] - pos[:, None, :, :]       # (b, i, j, 3)
    dist2 = torch.sum(diff ** 2, dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    safe_dist = torch.sqrt(torch.where(eye, 1.0, dist2) + 1e-20)
    return safe_dist, diff / safe_dist[..., None]


class _EGLayer(nn.Module):
    """One dense equivariant message-passing layer."""

    def __init__(self, generator, r_cutoff, node_feat_dim, distance_feat_dim,
                 speed_factor, initialize_identity=True, device=None,
                 dtype=torch.float32, pairwise='dense', compute_dtype=None):
        super().__init__()
        if pairwise == 'fused' and compute_dtype is not None:
            raise ValueError(
                "pairwise='fused' does not support compute_dtype: the fused "
                'kernels run in the storage dtype. Drop one of the two '
                'options.')
        F = node_feat_dim
        self.distance_embedding = BehlerParrinelloRadialExpansion.from_range(
            r_cutoff=r_cutoff, n_gaussians=distance_feat_dim,
            max_mean=r_cutoff, trainable_stds=True, device=device,
            dtype=dtype)
        kwargs = dict(device=device, dtype=dtype, compute_dtype=compute_dtype)
        self.message_mlp = _MLP(generator, [2 * F + distance_feat_dim, F, F],
                                final_activation='silu', **kwargs)
        self.attention_mlp = _MLP(generator, [F, 1],
                                  final_activation='sigmoid', **kwargs)
        self.update_x_mlp = _MLP(generator, [F, F, 1],
                                 final_activation='tanh', bias_last=False,
                                 **kwargs)
        self.update_h_mlp = _MLP(generator, [2 * F, F, F], **kwargs)
        self.r_cutoff = float(r_cutoff)
        self.speed_factor = float(speed_factor)
        self.pairwise = pairwise
        if initialize_identity:
            # Zero the last update_x weight -> zero displacements.
            with torch.no_grad():
                self.update_x_mlp.layers[-1].weight.zero_()

    def _first_blocks(self, F):
        """The message MLP's first weight split by input block. Reference
        order: the FIRST block multiplies the sender (j), the second the
        receiver (i), the third the distance embedding."""
        w = self.message_mlp.layers[0].effective_weight()
        return w[:, :F], w[:, F:2 * F], w[:, 2 * F:]

    def _update(self, h, node_messages, pos, directions, magnitudes):
        h = h + self.update_h_mlp(torch.cat([h, node_messages], dim=-1))
        pos = pos + torch.sum(
            self.speed_factor * directions * magnitudes[..., None], dim=2)
        return h, pos

    def forward(self, h, pos):
        """``h``: (batch, n, feat); ``pos``: (batch, n, 3)."""
        F = h.shape[-1]
        safe_dist, directions = _geometry(pos)
        w_j, w_i, w_e = self._first_blocks(F)
        if self.pairwise == 'fused':
            node_messages, magnitudes = egnn_pairwise(
                h @ w_i.T, h @ w_j.T, safe_dist, *self._kernel_weights(w_e),
                self.r_cutoff)
            return self._update(h, node_messages, pos, directions,
                                magnitudes)

        n = h.shape[1]
        eye = torch.eye(n, dtype=torch.bool, device=h.device)
        mask_f = ((~eye) & (safe_dist <= self.r_cutoff)).to(h.dtype)[..., None]
        # Factored first layer: (W_i h_i) + (W_j h_j) + W_e emb, instead of
        # a per-pair product over the (b, n, n, 2 feat + dfeat) concatenation.
        dist_emb = self.distance_embedding(safe_dist)
        cd = self.message_mlp.layers[0].compute_dtype
        pre = (low_precision_matmul(h, w_i, cd)[:, :, None, :]
               + low_precision_matmul(h, w_j, cd)[:, None, :, :]
               + low_precision_matmul(dist_emb, w_e, cd))
        bias = self.message_mlp.layers[0].bias
        if bias is not None:
            pre = pre + bias
        messages = self.message_mlp.finish(pre)
        messages = messages * self.attention_mlp(messages) * mask_f

        h = h + self.update_h_mlp(
            torch.cat([h, torch.sum(messages, dim=2)], dim=-1))
        disp = (self.speed_factor * directions * self.update_x_mlp(messages)
                * mask_f)
        return h, pos + torch.sum(disp, dim=2)

    def _kernel_weights(self, w_e):
        """The eleven weights in the kernels' argument order, contiguous."""
        emb = self.distance_embedding
        msg, att, upd = (self.message_mlp.layers, self.attention_mlp.layers,
                         self.update_x_mlp.layers)
        weights = (emb.means, emb.log_gammas, w_e, msg[0].bias,
                   msg[1].effective_weight(), msg[1].bias,
                   att[0].effective_weight()[0], att[0].bias,
                   upd[0].effective_weight(), upd[0].bias,
                   upd[1].effective_weight()[0])
        return tuple(w.contiguous() for w in weights)

    def forward_and_jvp(self, h, dh, pos, dpos):
        """The layer and its tangent: ``(h', dh', pos', dpos')`` for the
        tangents ``dh``, ``dpos`` of its inputs (the weights' are zero)."""
        if self.pairwise != 'fused':
            return _jvp(self.forward, (h, pos), (dh, dpos))
        F = h.shape[-1]
        (safe_dist, directions), (d_dist, d_directions) = torch.func.jvp(
            _geometry, (pos,), (dpos,))
        w_j, w_i, w_e = self._first_blocks(F)
        nm, mag, dnm, dmag = egnn_pairwise_jvp(
            h @ w_i.T, h @ w_j.T, safe_dist, *self._kernel_weights(w_e),
            dh @ w_i.T, dh @ w_j.T, d_dist, self.r_cutoff)
        return _jvp(self._update, (h, nm, pos, directions, mag),
                    (dh, dnm, dpos, d_directions, dmag))


def _jvp(fn, primals, tangents):
    """``torch.func.jvp`` of a function of two outputs, flattened to
    ``(out_1, tangent_1, out_2, tangent_2)``."""
    (a, b), (da, db) = torch.func.jvp(fn, primals, tangents)
    return a, da, b, db


class EGNNDynamics(nn.Module):
    """EGNN velocity field ``v = f(t, x)`` for CNFs.

    Equivariant under rotations and permutations of same-type atoms and
    invariant under translations (the mean velocity is removed). Build
    with :meth:`create`; parameters as the JAX package's
    ``EGNNDynamics.create``, with a ``torch.Generator`` for the key, and:

    - ``pairwise`` — ``'dense'`` (default) or ``'fused'`` (kernels K3-K5);
    - ``device`` — defaults to ``cuda`` and raises without a card;
    - ``compute_dtype`` — e.g. ``'bfloat16'``: the message and update
      products on operands rounded to it with a float32 sum, the
      parameters in ``dtype`` (:func:`~tfep_tpu_torch.nn.masked.
      low_precision_matmul`); only with ``pairwise='dense'``, as in JAX.
    """

    def __init__(self, one_hot, time_embedding, h_embedding, graph_layers):
        super().__init__()
        self.register_buffer('node_types_one_hot', one_hot)
        self.time_embedding = time_embedding
        self.h_embedding = h_embedding
        self.graph_layers = nn.ModuleList(graph_layers)
        self.n_nodes = one_hot.shape[0]

    @classmethod
    def create(cls, generator: torch.Generator, node_types: Sequence[int],
               r_cutoff: float, time_feat_dim: int = 16,
               node_feat_dim: int = 64, distance_feat_dim: int = 64,
               n_layers: int = 4, speed_factor: float = 1.0,
               initialize_identity: bool = True, device=None,
               dtype: torch.dtype = torch.float32, compute_dtype=None,
               pairwise: str = 'dense') -> 'EGNNDynamics':
        if pairwise not in _PAIRWISE:
            raise ValueError(f'pairwise must be one of {_PAIRWISE}, got '
                             f'{pairwise!r}.')
        device = resolve_device(device)
        node_types = np.asarray(node_types)
        n_types = int(node_types.max()) + 1
        one_hot = torch.as_tensor(np.eye(n_types)[node_types], dtype=dtype,
                                  device=device)
        layers = [_EGLayer(generator, r_cutoff, node_feat_dim,
                           distance_feat_dim, speed_factor,
                           initialize_identity, device=device, dtype=dtype,
                           pairwise=pairwise, compute_dtype=compute_dtype)
                  for _ in range(n_layers)]
        return cls(
            one_hot,
            GaussianBasisExpansion.from_range(
                n_gaussians=time_feat_dim, max_mean=1.0,
                trainable_stds=True, device=device, dtype=dtype),
            MaskedLinear(generator, n_types + time_feat_dim, node_feat_dim,
                         device=device, dtype=dtype),
            layers)

    @property
    def pairwise(self) -> str:
        return self.graph_layers[0].pairwise if self.graph_layers else 'dense'

    def _node_features(self, t, x):
        """Initial node features ``(batch, n, feat)``: one-hot types ++
        Gaussian-embedded time, through ``h_embedding``."""
        t = torch.as_tensor(t, dtype=self.time_embedding.means.dtype,
                            device=x.device).reshape(1)
        t_embedded = self.time_embedding(t).reshape(-1).to(x.dtype)
        h = torch.cat([
            self.node_types_one_hot.to(x.dtype),
            t_embedded[None, :].expand(self.n_nodes, -1)], dim=-1)
        h = self.h_embedding(h)                          # (n, feat)
        return h[None].expand(x.shape[0], *h.shape)

    def _velocity(self, pos, x):
        batch = x.shape[0]
        vel = pos.reshape(batch, -1) - x
        # Remove the mean so the center of geometry is preserved.
        vel_atoms = vel.reshape(batch, self.n_nodes, 3)
        vel_atoms = vel_atoms - torch.mean(vel_atoms, dim=1, keepdim=True)
        return vel_atoms.reshape(batch, -1)

    def forward(self, t, x):
        """``t`` scalar; ``x``: (batch, n_nodes*3) -> velocities, same shape."""
        h = self._node_features(t, x)
        pos = x.reshape(x.shape[0], self.n_nodes, 3)
        for layer in self.graph_layers:
            h, pos = layer(h, pos)
        return self._velocity(pos, x)

    def forward_and_jvp(self, t, x, v):
        """``(f(t, x), J_x f(t, x) v)``: the counterpart of
        ``jax.jvp(lambda z: dynamics(t, z), (x,), (v,))``."""
        if self.pairwise != 'fused':
            return torch.func.jvp(lambda z: self(t, z), (x,), (v,))
        # Contiguous: torch.func.jvp takes no primal with repeated memory.
        h = self._node_features(t, x).contiguous()
        dh = torch.zeros_like(h)
        batch = x.shape[0]
        pos = x.reshape(batch, self.n_nodes, 3)
        dpos = v.reshape(batch, self.n_nodes, 3)
        for layer in self.graph_layers:
            h, dh, pos, dpos = layer.forward_and_jvp(h, dh, pos, dpos)
        return self._velocity(pos, x), self._velocity(dpos, v)
