"""Plain PyTorch reference of the CNF map: an E(n)-equivariant graph network
as the velocity field of a continuous normalizing flow.

Written from the published method (Satorras et al. 2021, E(n) equivariant
graph networks and normalizing flows; FFJORD's Hutchinson trace, Grathwohl
et al. 2019; Finlay et al. 2020's kinetic and Frobenius regularization) in
the form the configuration states: messages over every atom pair, a
Gaussian radial basis under a cosine cutoff envelope, sigmoid attention,
tanh-bounded displacements along unit directions, residual feature
updates, the mean velocity removed; fixed-step rk4; one Gaussian probe per
frame. It imports neither the program nor the JAX package: every pair's
message is computed densely with plain operations, and so is the probe's
tangent, each operation's derivative written out beside it (autograd then
differentiates both); in blocks of frames, each evaluation of the field
recomputed in the backward pass (``torch.utils.checkpoint``) so that a
block fits.

Weights are keyed ``time.log_gammas``, ``embed.{weight,bias}`` and
``l{layer}.{radial.log_gammas, msg0, msg1, att, x0, x1, h0, h1}``. The optimizer is
:func:`tfep_bench.reference.adamw.adamw`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tfep_bench.reference.adamw import adamw

# Frames per block: the reference is paced by its operations' count more
# than by their size; a block of 1024 holds some 35 GB.
BLOCK = 1024


def structure(cfg):
    return dict(n=int(cfg['n_atoms']), F=int(cfg['node_feat_dim']),
                D=int(cfg['distance_feat_dim']), T=int(cfg['time_feat_dim']),
                L=int(cfg['n_egnn_layers']), types=int(cfg['n_types']),
                rc=float(cfg['r_cutoff']), steps=int(cfg['ode_steps']))


def _log_gamma(n, max_mean):
    """``log(1 / std^2)`` of equidistant Gaussians on ``[0, max_mean]``
    with ``std = 3 * spacing``."""
    return math.log(1.0 / (3.0 * max_mean / (n - 1)) ** 2)


def weight_spec(s):
    """``[(key, shape, low, high)]``: products uniform in +-1/sqrt(fan in),
    as a dense layer's, but the displacement's last product (``x1``) in a
    tenth of that, so that the field starts near, not at, the identity
    map's zero (at the full range a step moves the loss by 40%, and the
    regularizer of a field that rough is most of it); the Gaussians' log
    inverse variances within 0.1 of their equidistant value."""
    F, D, T = s['F'], s['D'], s['T']

    def linear(key, n_out, n_in, bias=True, scale=1.0):
        b = scale / math.sqrt(n_in)
        out = [(f'{key}.weight', (n_out, n_in), -b, b)]
        return out + ([(f'{key}.bias', (n_out,), -b, b)] if bias else [])

    g = _log_gamma(T, 1.0)
    spec = [('time.log_gammas', (T,), g - 0.1, g + 0.1)]
    spec += linear('embed', F, s['types'] + T)
    g = _log_gamma(D, s['rc'])
    for layer in range(s['L']):
        k = f'l{layer}'
        spec += [(f'{k}.radial.log_gammas', (D,), g - 0.1, g + 0.1)]
        spec += linear(f'{k}.msg0', F, 2 * F + D) + linear(f'{k}.msg1', F, F)
        spec += linear(f'{k}.att', 1, F) + linear(f'{k}.x0', F, F)
        spec += linear(f'{k}.x1', 1, F, bias=False, scale=0.1)
        spec += linear(f'{k}.h0', F, 2 * F) + linear(f'{k}.h1', F, F)
    return spec


def _lin(w, key, x):
    y = x @ w[f'{key}.weight'].T
    return y + w[f'{key}.bias'] if f'{key}.bias' in w else y


def _silu(x):
    """``silu(x)`` and its derivative."""
    sg = torch.sigmoid(x)
    return x * sg, sg * (1 + x * (1 - sg))


def field(t, x, v, w, s, types):
    """The velocity ``f(t, x)`` on ``(B, 3 n)`` frames and its tangent
    ``J v`` along ``v``, each operation's derivative written out."""
    B, n, F = x.shape[0], s['n'], s['F']
    means = torch.linspace(0.0, 1.0, s['T'], dtype=x.dtype, device=x.device)
    temb = torch.exp(-torch.exp(w['time.log_gammas']) * (t - means) ** 2)
    onehot = torch.nn.functional.one_hot(types, s['types']).to(x.dtype)
    h = _lin(w, 'embed', torch.cat([onehot, temb.expand(n, -1)], 1))
    h, dh = h.expand(B, n, F), torch.zeros((B, n, F), dtype=x.dtype,
                                           device=x.device)
    pos, dpos = x.reshape(B, n, 3), v.reshape(B, n, 3)
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    mu = torch.linspace(0.0, s['rc'], s['D'], dtype=x.dtype, device=x.device)
    c = math.pi / s['rc']
    for layer in range(s['L']):
        k = f'l{layer}'
        # Receiver i, sender j.
        diff = pos[:, :, None] - pos[:, None, :]
        ddiff = dpos[:, :, None] - dpos[:, None, :]
        d = torch.sqrt(torch.where(eye, 1.0, (diff ** 2).sum(-1)) + 1e-20)
        dd = torch.where(eye, 0.0, (diff * ddiff).sum(-1)) / d
        unit = diff / d[..., None]
        dunit = ddiff / d[..., None] - diff * (dd / d ** 2)[..., None]
        inside = d <= s['rc']
        env = torch.where(inside, 0.5 * torch.cos(c * d) + 0.5, 0.0)
        denv = torch.where(inside, -0.5 * c * torch.sin(c * d), 0.0) * dd
        gam = torch.exp(w[f'{k}.radial.log_gammas'])
        r = d[..., None] - mu
        g = torch.exp(-gam * r * r)
        emb = g * env[..., None]
        demb = (g * env[..., None] * (-2 * gam * r) * dd[..., None]
                + g * denv[..., None])
        near = ((~eye) & inside).to(x.dtype)[..., None]
        w0 = w[f'{k}.msg0.weight']
        wj, wi, we = w0[:, :F], w0[:, F:2 * F], w0[:, 2 * F:]
        pre = (h @ wi.T)[:, :, None] + (h @ wj.T)[:, None] + emb @ we.T \
            + w[f'{k}.msg0.bias']
        dpre = (dh @ wi.T)[:, :, None] + (dh @ wj.T)[:, None] + demb @ we.T
        s1, s1p = _silu(pre)
        m1, m1p = _silu(_lin(w, f'{k}.msg1', s1))
        dm1 = m1p * ((s1p * dpre) @ w[f'{k}.msg1.weight'].T)
        a = torch.sigmoid(_lin(w, f'{k}.att', m1))
        da = a * (1 - a) * (dm1 @ w[f'{k}.att.weight'].T)
        m = m1 * a * near
        dm = (dm1 * a + m1 * da) * near
        q, qp = _silu(_lin(w, f'{k}.x0', m))
        dq = qp * (dm @ w[f'{k}.x0.weight'].T)
        st = torch.tanh(_lin(w, f'{k}.x1', q))
        dst = (1 - st * st) * (dq @ w[f'{k}.x1.weight'].T)
        u, up = _silu(_lin(w, f'{k}.h0', torch.cat([h, m.sum(2)], -1)))
        du = up * (torch.cat([dh, dm.sum(2)], -1) @ w[f'{k}.h0.weight'].T)
        h, dh = h + _lin(w, f'{k}.h1', u), dh + du @ w[f'{k}.h1.weight'].T
        pos = pos + (unit * st * near).sum(2)
        dpos = dpos + ((dunit * st + unit * dst) * near).sum(2)

    def centred(p, p0):
        vel = (p.reshape(B, -1) - p0).reshape(B, n, 3)
        return (vel - vel.mean(1, keepdim=True)).reshape(B, -1)

    return centred(pos, x), centred(dpos, v)


def flow(x, eps, w, s, types):
    """The time-1 map with its log-det and regularizer (``(B, 3n)``,
    ``(B,)``, ``(B,)``): rk4 on the state (x, log-det, |f|^2 + |J e|^2),
    each evaluation of the field recomputed in the backward pass."""

    def rhs(t, *state):
        v, jv = field(t, state[0], eps, w, s, types)
        return v, (eps * jv).sum(1), (v * v).sum(1) + (jv * jv).sum(1)

    def stage(t, state):
        return checkpoint(rhs, t, *state, use_reentrant=False)

    zero = torch.zeros_like(x[:, 0])
    state = (x, zero, zero)
    dt = 1.0 / s['steps']
    for i in range(s['steps']):
        t = i * dt
        k1 = stage(t, state)
        k2 = stage(t + dt / 2, [a + dt / 2 * b for a, b in zip(state, k1)])
        k3 = stage(t + dt / 2, [a + dt / 2 * b for a, b in zip(state, k2)])
        k4 = stage(t + dt, [a + dt * b for a, b in zip(state, k3)])
        state = tuple(a + dt * (b1 + 2 * b2 + 2 * b3 + b4) / 6
                      for a, b1, b2, b3, b4 in zip(state, k1, k2, k3, k4))
    return state


def probes(seed, indices, step, shape, dtype, device):
    """The Hutchinson probe of a batch: a Gaussian draw from a generator
    seeded by the map's seed, the batch's sample indices and the step."""
    idx = np.asarray(indices).astype(np.uint64)
    weights = 2 * np.arange(len(idx), dtype=np.uint64) + 1
    fold = int(np.sum(idx * weights) % (1 << 32))
    state = np.random.SeedSequence([seed + 1, fold, int(step)]).generate_state(
        2, np.uint32).astype(np.uint64)
    g = torch.Generator(device=device).manual_seed(
        int(state[0] << np.uint64(32) | state[1]))
    return torch.randn((1, *shape), generator=g, dtype=dtype,
                       device=device)[0]


def context(cfg, frames):
    s = structure(cfg)
    types = torch.as_tensor(np.arange(s['n']) % s['types'],
                            device=frames.device)
    return dict(s=s, types=types, seed=int(cfg['map_seed']))


def loss_and_grads(ctx, weights, x, eps):
    """``mean(0.5 |y|^2 - log_det_J) + mean(reg)`` and its gradient,
    summed over blocks of frames."""
    leaves = {k: v.detach().requires_grad_() for k, v in weights.items()}
    grads = {k: torch.zeros_like(v) for k, v in weights.items()}
    B, total = x.shape[0], 0.0
    for start in range(0, B, BLOCK):
        y, ldj, reg = flow(x[start:start + BLOCK], eps[start:start + BLOCK],
                           leaves, ctx['s'], ctx['types'])
        part = (0.5 * (y * y).sum(1) - ldj + reg).sum() / B
        for k, g in zip(leaves, torch.autograd.grad(part, list(
                leaves.values()), allow_unused=True)):
            if g is not None:
                grads[k] += g
        total += float(part.detach())
    return total, grads


def train_steps(ctx, weights, batches):
    """The steps on ``batches`` (``positions``, ``indices``, ``step``):
    losses, the first gradient, the weights after the last step."""
    state, losses, first = {}, [], None
    for b in batches:
        x = b['positions']
        eps = probes(ctx['seed'], b['indices'], b['step'], x.shape, x.dtype,
                     x.device)
        loss, grads = loss_and_grads(ctx, weights, x, eps)
        first = grads if first is None else first
        losses.append(loss)
        weights = adamw(weights, grads, state)
    return losses, first, weights
