"""Plain PyTorch reference of the flagship map: a MixedMAFMap on a bonded chain.

Written from the published method (upstream tfep's ``MixedMAFMap``: a
Z-matrix per fragment from the bond graph, Cartesian <-> mixed internal
coordinates with the exact log-det, MAF layers of a MADE conditioner with
weight normalization and a periodic (cos, sin) embedding of the torsions,
rational-quadratic splines per coordinate type; Durkan et al. 2019 for the
splines) and nothing else: it imports neither the program nor the JAX
package. Everything the program derives from the data is worked out here
again: the Z-matrix, the degrees and masks, the spline domains.

Each step is plain: one row at a time in the Z-matrix, every bin of a
spline evaluated and the input's selected by a mask, dense masked
products. It runs in the dtype of its inputs.

Weights are keyed ``maf{layer}.{linear}.{weight|bias|gain}``; the
benchmark draws them (:func:`weight_spec`) and hands the same values to
the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tfep_bench.reference.adamw import adamw

MIN_BIN = 1e-4
MIN_SLOPE = 1e-4
# Frames the spline domains are taken over (at most), and the room left
# below each bond's observed minimum.
DOMAIN_FRAMES = 5 * 1024
DISTANCE_DISPLACEMENT = 0.3


# =============================================================================
# Structure: the Z-matrix, the coordinate layout, the degrees
# =============================================================================

def _hops(adj, source, cutoff=None):
    """{atom: bond hops from source}, breadth first."""
    seen = {source: 0}
    frontier = [source]
    level = 0
    while frontier and (cutoff is None or level < cutoff):
        level += 1
        nxt = []
        for a in frontier:
            for b in adj[a]:
                if b not in seen:
                    seen[b] = level
                    nxt.append(b)
        frontier = nxt
    return seen


def z_matrix(n_atoms, bonds):
    """The (origin, axis, plane) atoms and the Z-matrix rows ``[i, j, k,
    l]`` of one connected molecule of heavy atoms, by the upstream
    heuristic: start at the graph's first central atom and add atoms
    breadth first; each atom is bonded to its nearest placed atom, and its
    angle and torsion atoms are the placed atoms nearest to it and to its
    bond atom, the most recently placed first (upstream also puts heavy
    atoms before hydrogens, which a molecule of heavy atoms never asks)."""
    adj = {a: [] for a in range(n_atoms)}
    for a, b in bonds:
        adj[a].append(b)
        adj[b].append(a)
    ecc = {a: max(_hops(adj, a).values()) for a in adj}
    root = min(adj, key=lambda a: (ecc[a], a))
    near = {a: _hops(adj, a, cutoff=3) for a in adj}
    order = {root: 0}
    rows = [[root]]

    def ranked(atom, bond_atom=None):
        keys = []
        for prev, d in near[atom].items():
            if prev not in order or prev == atom or prev == bond_atom:
                continue
            if bond_atom is not None and prev not in near[bond_atom]:
                continue
            d_bond = 0 if bond_atom is None else near[bond_atom][prev]
            keys.append(((d, d_bond, -order[prev]), prev))
        return [prev for _, prev in sorted(keys)]

    seen = {root}
    frontier = [root]
    while frontier:
        nxt = []
        for parent in frontier:
            for atom in adj[parent]:
                if atom in seen:
                    continue
                seen.add(atom)
                nxt.append(atom)
                bond = ranked(atom)[0]
                rows.append([atom, bond] + ranked(atom, bond)[:2])
                order[atom] = len(order)
        frontier = nxt
    frame = [rows[0][0], rows[1][0], rows[2][0]]
    return frame, np.asarray(rows[3:], dtype=np.int64)


class Layout:
    """Where each mixed coordinate lives: ``[bonds, angles, torsions, d01,
    d02, a102, origin xyz, axis yz, plane z]`` (the last six are the
    frame's constant coordinates, seen by the conditioner only)."""

    def __init__(self, n_atoms, bonds):
        self.frame, self.z = z_matrix(n_atoms, bonds)
        self.n_atoms = n_atoms
        n_ic = len(self.z)
        self.n_ic = n_ic
        self.n = 3 * n_ic + 3 + 6
        self.distances = np.r_[np.arange(n_ic), 3 * n_ic, 3 * n_ic + 1]
        self.angles = np.r_[np.arange(n_ic, 2 * n_ic), 3 * n_ic + 2]
        self.torsions = np.arange(2 * n_ic, 3 * n_ic)
        self.n_mapped = 3 * n_ic + 3


def degrees(n_mapped, n_constant, descending):
    """Input degrees: 0..n-1 (or reversed) on the mapped coordinates, -1 on
    the constant ones."""
    d = np.arange(n_mapped)
    return np.r_[d[::-1] if descending else d, -np.ones(n_constant, int)]


def embedded_degrees(deg, torsions):
    """The degrees of the conditioner's input: the non-periodic
    coordinates, then each torsion's cos and sin."""
    rest = np.setdiff1d(np.arange(len(deg)), torsions)
    return np.r_[deg[rest], np.repeat(deg[torsions], 2)], rest


def _tile(x, n):
    full, rem = divmod(n, len(x))
    return np.r_[np.tile(x, full), x[:rem]]


def made_degrees(deg_in, deg_out, n_hidden=2):
    """Degrees of every MADE layer: the hidden nodes take the input
    degrees that some output can use, round robin, ``ceil(sqrt(n_relevant *
    n_out))`` of them (at least ``n_relevant``)."""
    motif = deg_in[deg_in < deg_out.max()]
    width = max(int(math.ceil(math.sqrt(len(motif) * len(deg_out)))),
                len(motif))
    return [deg_in] + [_tile(motif, width)] * n_hidden + [deg_out]


class Spec:
    """The sizes of one map: per MAF layer the input degrees, the MADE
    layers' degrees, the spline groups and their parameter counts."""

    def __init__(self, n_atoms, bonds, n_layers, n_bins):
        self.layout = L = Layout(n_atoms, bonds)
        self.n_layers, self.K = n_layers, n_bins
        K = n_bins
        # Parameters per coordinate: distances pin the boundary slopes and
        # learn the upper bound; angles take the plain spline; torsions
        # are circular with a phase shift.
        self.groups = [(L.distances, 3 * K), (L.angles, 3 * K + 1),
                       (L.torsions, 3 * K + 1)]
        self.layers = []
        for layer in range(n_layers):
            deg = degrees(L.n_mapped, L.n - L.n_mapped,
                          descending=layer % 2 == 1)
            emb_deg, rest = embedded_degrees(deg, L.torsions)
            deg_out = np.concatenate([np.tile(deg[idx], n)
                                      for idx, n in self.groups])
            self.layers.append(dict(degrees=made_degrees(emb_deg, deg_out),
                                    rest=rest))

    def masks(self, layer):
        d = self.layers[layer]['degrees']
        n = len(d) - 1
        return [(d[j + 1][:, None] > d[j][None, :]) if j == n - 1
                else (d[j + 1][:, None] >= d[j][None, :]) for j in range(n)]


def weight_spec(spec):
    """``[(key, shape, low, high)]`` of every trained leaf: weights uniform
    in +-1/sqrt(fan in), as a dense layer's; gains (the row norms of the
    weight normalization) in [0.5, 1.5] for hidden layers and [0, 0.1] for
    the output, so that the map starts near, not at, the identity (a
    trained map's splines are smooth; gains near 1 at the output give bins
    of widths 400 times apart, whose slopes amplify float32 rounding by as
    much)."""
    out = []
    for layer in range(spec.n_layers):
        d = spec.layers[layer]['degrees']
        for j in range(len(d) - 1):
            n_in, n_out = len(d[j]), len(d[j + 1])
            bound = 1.0 / math.sqrt(n_in)
            last = j == len(d) - 2
            key = f'maf{layer}.{j}'
            out += [(f'{key}.weight', (n_out, n_in), -bound, bound),
                    (f'{key}.bias', (n_out,), -bound, bound),
                    (f'{key}.gain', (n_out, 1), 0.0 if last else 0.5,
                     0.1 if last else 1.5)]
    return out


# =============================================================================
# Geometry
# =============================================================================

def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _angle(a, b):
    cos = (a * b).sum(-1) / (torch.linalg.norm(a, dim=-1)
                            * torch.linalg.norm(b, dim=-1))
    return torch.arccos(cos.clamp(-1.0, 1.0))


def _dihedral(p0, p1, p2, p3):
    b1 = _unit(p2 - p1)
    v = (p0 - p1) - ((p0 - p1) * b1).sum(-1, keepdim=True) * b1
    w = (p3 - p2) - ((p3 - p2) * b1).sum(-1, keepdim=True) * b1
    x = (v * w).sum(-1)
    y = (torch.linalg.cross(b1, v, dim=-1) * w).sum(-1)
    return torch.atan2(y, x)


def _rodrigues(angle, axis):
    k = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    c, s = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    zero = torch.zeros_like(k[:, 0])
    kx = torch.stack([torch.stack([zero, -k[:, 2], k[:, 1]], -1),
                      torch.stack([k[:, 2], zero, -k[:, 0]], -1),
                      torch.stack([-k[:, 1], k[:, 0], zero], -1)], -2)
    eye = torch.eye(3, dtype=angle.dtype, device=angle.device)
    return c * eye + (1 - c) * k[:, :, None] * k[:, None, :] + s * kx


def frame_rotation(axis_atom, plane_atom):
    """The rotation taking the axis atom onto +x and the plane atom into
    the xy plane, on the side of y it lies after the first rotation."""
    ex = torch.zeros_like(axis_atom)
    ex[:, 0] = 1.0
    ey = torch.zeros_like(axis_atom)
    ey[:, 1] = 1.0
    ez = torch.zeros_like(axis_atom)
    ez[:, 2] = 1.0
    turn = torch.linalg.cross(axis_atom, ex, dim=-1)
    parallel = torch.isclose(turn, torch.zeros_like(turn), rtol=1e-5,
                             atol=1e-8).all(-1, keepdim=True)
    turn = torch.where(parallel, torch.linalg.cross(ey, ex, dim=-1), turn)
    r1 = _rodrigues(_angle(axis_atom, ex), turn)
    p = torch.einsum('bij,bj->bi', r1, plane_atom)
    p = p - ex * p[:, :1]
    tilt = torch.arcsin(((p * ez).sum(-1) / torch.linalg.norm(p, dim=-1)
                         ).clamp(-1.0, 1.0))
    r2 = _rodrigues(-torch.sign(p[:, 1]) * tilt, ex)
    return r2 @ r1


def to_mixed(x, L):
    """Cartesian ``(B, 3 n_atoms)`` -> mixed coordinates, their log-det,
    and the frame for the way back."""
    B = x.shape[0]
    atoms = x.reshape(B, L.n_atoms, 3)
    z = torch.as_tensor(L.z, device=x.device)
    pi, pj, pk, pl = (atoms[:, z[:, c]] for c in range(4))
    r = torch.linalg.norm(pi - pj, dim=-1)
    theta = _angle(pi - pj, pk - pj)
    phi = _dihedral(pi, pj, pk, pl)
    ldj = (-2 * torch.log(r) - torch.log(torch.sin(theta))).sum(-1) \
        - L.n_ic * (math.log(math.pi) + math.log(2 * math.pi))
    o, a, p = (atoms[:, i] for i in L.frame)
    R = frame_rotation(a - o, p - o)
    rel = torch.einsum('bij,bkj->bki', R,
                       torch.stack([o, a, p], 1) - o[:, None])
    d01 = rel[:, 1, 0]
    d02 = torch.sqrt(rel[:, 2, 0] ** 2 + rel[:, 2, 1] ** 2)
    a102 = torch.atan2(rel[:, 2, 1], rel[:, 2, 0])
    ldj = ldj - 2 * torch.log(d01) - 2 * torch.log(d02) \
        - torch.log(torch.abs(torch.sin(a102))) - math.log(2 * math.pi)
    const = torch.stack([rel[:, 0, 0], rel[:, 0, 1], rel[:, 0, 2],
                         rel[:, 1, 1], rel[:, 1, 2], rel[:, 2, 2]], 1)
    y = torch.cat([r, theta / math.pi, (phi + math.pi) / (2 * math.pi),
                   d01[:, None], d02[:, None],
                   ((a102 + math.pi) / (2 * math.pi))[:, None], const], 1)
    return y, ldj, o, R


def _place(pj, pk, pl, r, theta, phi):
    e1 = _unit(pk - pj)
    n = _unit(torch.linalg.cross(pl - pk, pk - pj, dim=-1))
    m = torch.linalg.cross(n, e1, dim=-1)
    d = torch.cos(theta)[:, None] * e1 + torch.sin(theta)[:, None] * (
        -torch.cos(phi)[:, None] * m + torch.sin(phi)[:, None] * n)
    return pj + r[:, None] * d


def to_cartesian(y, o, R, L):
    """Inverse of :func:`to_mixed` in the frame it returned."""
    B, n = y.shape[0], L.n_ic
    r, theta, phi = y[:, :n], y[:, n:2 * n] * math.pi, \
        y[:, 2 * n:3 * n] * 2 * math.pi - math.pi
    d01, d02 = y[:, 3 * n], y[:, 3 * n + 1]
    a102 = y[:, 3 * n + 2] * 2 * math.pi - math.pi
    c = y[:, 3 * n + 3:]
    ldj = math.log(2 * math.pi) + 2 * torch.log(d01) + 2 * torch.log(d02) \
        + torch.log(torch.abs(torch.sin(a102)))
    ldj = ldj + n * (math.log(math.pi) + math.log(2 * math.pi)) \
        + (2 * torch.log(r) + torch.log(torch.sin(theta))).sum(-1)
    rel = torch.stack([
        torch.stack([c[:, 0], c[:, 1], c[:, 2]], -1),
        torch.stack([d01, c[:, 3], c[:, 4]], -1),
        torch.stack([d02 * torch.cos(a102), d02 * torch.sin(a102),
                     c[:, 5]], -1)], 1)
    frame = torch.einsum('bji,bkj->bki', R, rel) + o[:, None]
    atoms = [None] * L.n_atoms
    for slot, i in enumerate(L.frame):
        atoms[i] = frame[:, slot]
    for row, (i, j, k, l) in enumerate(L.z.tolist()):
        atoms[i] = _place(atoms[j], atoms[k], atoms[l], r[:, row],
                          theta[:, row], phi[:, row])
    return torch.stack(atoms, 1).reshape(B, -1), ldj


# =============================================================================
# Splines
# =============================================================================

def _softplus(z):
    return torch.logaddexp(z, torch.zeros_like(z))


def rq_spline(x, x0, y0, widths, heights, slopes):
    """Rational-quadratic spline with linear tails: ``widths, heights (B,
    K, F)``, ``slopes (B, K+1, F)``; every bin is evaluated and the input's
    selected. Returns ``y`` and ``log dy/dx``, ``(B, F)``."""
    K = widths.shape[1]
    zero = torch.zeros_like(widths[:, :1])
    xk = x0 + torch.cat([zero, widths.cumsum(1)], 1)        # (B, K+1, F)
    yk = y0 + torch.cat([zero, heights.cumsum(1)], 1)
    s = heights / widths
    # Every bin is evaluated; clamped to the bin, the position keeps the
    # bins the input is not in finite (their gradient is then zero, not
    # zero times infinity).
    e = ((x[:, None] - xk[:, :-1]) / widths).clamp(0.0, 1.0)
    emo = e * (1 - e)
    denom = s + (slopes[:, 1:] + slopes[:, :-1] - 2 * s) * emo
    yb = yk[:, :-1] + heights * (s * e * e + slopes[:, :-1] * emo) / denom
    lb = torch.log(s * s * (slopes[:, 1:] * e * e + 2 * s * emo
                            + slopes[:, :-1] * (1 - e) ** 2)) \
        - 2 * torch.log(denom)
    inside = (x[:, None] >= xk[:, :-1]) & (x[:, None] < xk[:, 1:])
    last = torch.arange(K, device=x.device)[None, :, None] == K - 1
    inside = inside | (last & (x[:, None] >= xk[:, -1:]) & (
        x[:, None] <= xk[:, -1:]))
    y = torch.where(inside, yb, 0.0).sum(1)
    ld = torch.where(inside, lb, 0.0).sum(1)
    below, above = x < xk[:, 0], x > xk[:, -1]
    y = torch.where(below, y0 + slopes[:, 0] * (x - xk[:, 0]), y)
    y = torch.where(above, yk[:, -1] + slopes[:, -1] * (x - xk[:, -1]), y)
    ld = torch.where(below, torch.log(slopes[:, 0]), ld)
    ld = torch.where(above, torch.log(slopes[:, -1]), ld)
    return y, ld


def spline_group(kind, x, p, lo, hi, K):
    """One coordinate type's spline on ``x (B, F)`` with raw parameters
    ``p (B, n, F)``: ``distance`` (boundary slopes 1, learned upper bound),
    ``angle`` (plain), ``torsion`` (periodic, with a learned shift)."""
    offset = math.log(math.expm1(1.0 - MIN_SLOPE))
    width = hi - lo - K * MIN_BIN
    if kind == 'distance':
        raw = torch.cat([torch.zeros_like(p[:, :1]), p[:, 2 * K:3 * K - 1],
                         torch.zeros_like(p[:, :1])], 1)
        width = width * torch.exp(p[:, -1:])
    elif kind == 'angle':
        raw = p[:, 2 * K:3 * K + 1]
    else:
        raw = torch.cat([p[:, 2 * K:3 * K], p[:, 2 * K:2 * K + 1]], 1)
        x = torch.remainder(x - lo + p[:, -1], hi - lo) + lo
    widths = torch.softmax(p[:, :K], 1) * width + MIN_BIN
    heights = torch.softmax(p[:, K:2 * K], 1) * width + MIN_BIN
    slopes = _softplus(raw + offset) + MIN_SLOPE
    return rq_spline(x, lo, lo, widths, heights, slopes)


# =============================================================================
# The map, the loss, the steps
# =============================================================================

def domains(frames, spec, block=1024):
    """Per mixed coordinate ``(lo, hi)`` of the spline domains from at
    most :data:`DOMAIN_FRAMES` frames, evenly strided: the observed range
    of the bonds (lowered by :data:`DISTANCE_DISPLACEMENT`, not below 0),
    [0, 1] for angles and torsions."""
    L = spec.layout
    n = frames.shape[0]
    stride = -(-n // DOMAIN_FRAMES) if n > DOMAIN_FRAMES else 1
    picked = frames[::stride]
    lo = hi = None
    with torch.no_grad():
        for start in range(0, picked.shape[0], block):
            y = to_mixed(picked[start:start + block], L)[0]
            a, b = y.amin(0), y.amax(0)
            lo = a if lo is None else torch.minimum(lo, a)
            hi = b if hi is None else torch.maximum(hi, b)
    lo, hi = lo.clone(), hi.clone()
    d, u = torch.as_tensor(L.distances), np.r_[L.angles, L.torsions]
    lo[d] = torch.clamp(lo[d] - DISTANCE_DISPLACEMENT, min=0.0)
    lo[u], hi[u] = 0.0, 1.0
    return lo, hi


def _made(h, weights, masks, key):
    for j, mask in enumerate(masks):
        v = torch.where(torch.as_tensor(mask, device=h.device),
                        weights[f'{key}.{j}.weight'], 0.0)
        sq = (v * v).sum(1, keepdim=True)
        w = weights[f'{key}.{j}.gain'] * v / torch.sqrt(
            torch.where(sq > 0, sq, 1.0))
        h = h @ w.T + weights[f'{key}.{j}.bias']
        if j < len(masks) - 1:
            h = torch.nn.functional.elu(h)
    return h


def maf_layer(y, weights, spec, layer, lo, hi):
    L, K = spec.layout, spec.K
    rest = spec.layers[layer]['rest']
    tors = y[:, L.torsions] * 2 * math.pi
    h = torch.cat([y[:, rest], torch.stack([torch.cos(tors),
                                            torch.sin(tors)], 2).flatten(1)],
                  1)
    params = _made(h, weights, spec.masks(layer), f'maf{layer}')
    out = y.clone()
    ldj = torch.zeros_like(y[:, 0])
    offset = 0
    for (idx, n), kind in zip(spec.groups, ('distance', 'angle', 'torsion')):
        f = len(idx)
        p = params[:, offset:offset + n * f].reshape(-1, n, f)
        offset += n * f
        out[:, idx], ld = spline_group(kind, y[:, idx], p, lo[idx], hi[idx],
                                       K)
        ldj = ldj + ld.sum(1)
    return out, ldj


def forward(x, weights, spec, lo, hi):
    """The map on Cartesian frames: ``(positions, log_det_J)``."""
    y, ldj, o, R = to_mixed(x, spec.layout)
    for layer in range(spec.n_layers):
        y, l = maf_layer(y, weights, spec, layer, lo, hi)
        ldj = ldj + l
    x_out, l = to_cartesian(y, o, R, spec.layout)
    return x_out, ldj + l


def work(x, weights, spec, lo, hi):
    """Per frame, the reduced potential ``0.5 |M(x)|^2`` (kT) of the
    harmonic target and ``log_det_J``."""
    y, ldj = forward(x, weights, spec, lo, hi)
    return 0.5 * (y * y).sum(1), ldj


def loss_and_grads(x, weights, spec, lo, hi, block=8192):
    """The TFEP loss ``mean(u(M(x)) - log_det_J)`` and its gradient with
    respect to every weight, summed over blocks of frames."""
    leaves = {k: v.detach().requires_grad_() for k, v in weights.items()}
    grads = {k: torch.zeros_like(v) for k, v in weights.items()}
    total = 0.0
    B = x.shape[0]
    for start in range(0, B, block):
        u, ldj = work(x[start:start + block], leaves, spec, lo, hi)
        part = (u - ldj).sum() / B
        for k, g in zip(leaves, torch.autograd.grad(part, list(
                leaves.values()), allow_unused=True)):
            if g is not None:
                grads[k] += g
        total += float(part.detach())
    return total, grads


def train(batches, weights, spec, lo, hi):
    """The steps on ``batches`` from ``weights``: each step's loss, the
    first step's gradient and the weights after the last step."""
    state, losses, first = {}, [], None
    for x in batches:
        loss, grads = loss_and_grads(x, weights, spec, lo, hi)
        first = grads if first is None else first
        losses.append(loss)
        weights = adamw(weights, grads, state)
    return losses, first, weights


# =============================================================================
# The benchmark's entry points
# =============================================================================

def structure(cfg) -> Spec:
    """The map's sizes for a configuration (a chain of ``n_atoms``)."""
    n = int(cfg['n_atoms'])
    if cfg['bonds'] != 'chain':
        raise ValueError(f'Unknown bond pattern {cfg["bonds"]!r}.')
    return Spec(n, [(i, i + 1) for i in range(n - 1)],
                int(cfg['n_maf_layers']), int(cfg['n_bins']))


def context(cfg, frames):
    """What the reference works out before a run's first step: the sizes
    and the spline domains over ``frames``."""
    spec = structure(cfg)
    lo, hi = domains(frames, spec)
    return dict(spec=spec, lo=lo, hi=hi)


def train_steps(ctx, weights, batches):
    """The steps on ``batches`` (``{'positions': ...}``): losses, the first
    gradient, the weights after the last step."""
    return train([b['positions'] for b in batches], weights, ctx['spec'],
                 ctx['lo'], ctx['hi'])


def evaluate(ctx, weights, frames, block=32768):
    """Per frame, the reduced potential and ``log_det_J``, float64 numpy."""
    us, ls = [], []
    with torch.no_grad():
        for start in range(0, frames.shape[0], block):
            u, l = work(frames[start:start + block], weights, ctx['spec'],
                        ctx['lo'], ctx['hi'])
            us.append(u.double().cpu())
            ls.append(l.double().cpu())
    return torch.cat(us).numpy(), torch.cat(ls).numpy()
