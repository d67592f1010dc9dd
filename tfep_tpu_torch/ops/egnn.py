"""Fused EGNN pairwise message block: CUDA C++ kernels for Hopper (K3, K4, K5).

Replaces the Pallas TPU kernels of ``tfep_tpu/ops/pallas/egnn.py``:

- K3, ``_forward_kernel`` (reached through ``_fwd_impl``): the block's
  primal outputs;
- K4, ``_jvp_kernel`` (reached through ``_jvp_op``): primal and tangent in
  one pass;
- K5, ``_jvp_bwd_kernel`` (reached through ``_jvp_op_bwd``): the VJP of the
  K4 pass, second order in the pairwise chain.

For each pair ``(b, i, j)`` (receiver ``i``, sender ``j``) the block takes
the Behler-Parrinello radial expansion ``emb`` of the distance, the
message MLP ``silu(W_m2 silu(a_i + a_j + W_e emb + b1) + b_m2)``, sigmoid
attention, the mask (off-diagonal and ``d <= r_cutoff``), the sum over
``j`` into node messages ``nm (B, n, F)``, and the displacement MLP
``tanh(w_x2 . silu(W_x1 msg + b_x1))``, masked, into ``mag (B, n, n)``.

What bounds them on an H100: operations. Each pair runs three
``(F, D)``/``(F, F)`` matrix-vector products (six with the tangent,
eighteen in K5), against a few hundred bytes of input per pair, so the
least time is the products' FLOPs over the card's float32 rate (counted
in :func:`k3_ops`, :func:`k4_ops`, :func:`k5_ops`).

Design (``tfep_tpu_torch/csrc/egnn.cu``). One block per frame ``b`` walks
the receiver rows ``i`` and, inside a row, tiles of up to 32 senders. The
three weight matrices (padded by one column against bank conflicts) and
every per-pair intermediate of a tile stay in shared memory; the products
are written in the kernel, each thread computing four pairs of one output
feature. With one block per frame, the sums over ``j`` (``nm``) and over
``i`` (``grad a_j`` in K5) stay inside the block, with no atomics. K5
recomputes the K4 chain of a tile, then runs its VJP; the eleven weight
gradients are summed per block into scratch and reduced over the frames
by a second kernel, in a fixed order (deterministic). Where shared memory
cannot hold it all (float64), the tile shrinks, then the weights and the
gradient sums move to device memory, by the same code.

Differentiation. JAX's ``custom_jvp`` yields primal and tangent from one
``custom_vjp`` op, so reverse mode sees only K4 and K5. In PyTorch a
``Function.jvp`` would leave the primal output to ``Function.forward``
under ``torch.func.jvp``, running K3 and K4 on every evaluation and giving
the primal a second backward. The port therefore mirrors JAX's launch
pattern: :class:`_EGNNPairwiseJVP` is a first-order Function whose
forward is K4 and whose backward is K5, and the EGNN layers compute their
tangents explicitly (``forward_and_jvp``). On every path of the package
the probe is a tangent of the positions alone, so the weights' tangents
are zero: the port passes only the tangents of ``a_i``, ``a_j`` and
``dist`` (JAX passes all 14, most of them zero), and K5 returns the six
per-frame gradients plus the eleven weight gradients through both the
primal and the tangent chains.

Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version (:func:`pairwise_reference`, :func:`pairwise_jvp_reference`,
:func:`pairwise_jvp_backward_reference`) only for CPU tensors. The kernels
are built from the source by ``nvcc`` at their first launch, into
``build/kernels`` of the checkout, and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from tfep_tpu_torch.ops import LaunchCounter

__all__ = ['egnn_pairwise', 'egnn_pairwise_jvp', 'pairwise_reference',
           'pairwise_jvp_reference', 'pairwise_jvp_backward_reference',
           'LAUNCHES', 'launch_k3', 'launch_k4', 'launch_k5', 'build',
           'k3_bytes', 'k4_bytes', 'k5_bytes', 'k3_ops', 'k4_ops', 'k5_ops',
           'n_weight_elements']

#: Names of the eleven weight arguments, in argument order.
WEIGHTS = ('mu', 'log_gammas', 'w_e', 'b1', 'w_m2', 'b_m2', 'w_att',
           'b_att', 'w_x1', 'b_x1', 'w_x2')


LAUNCHES = LaunchCounter('k3', 'k4', 'k5')


def _weight_shapes(F: int, D: int):
    return ((D,), (D,), (F, D), (F,), (F, F), (F,), (F,), (1,), (F, F),
            (F,), (F,))


def n_weight_elements(F: int, D: int) -> int:
    """Elements of the eleven weights (and of their gradients)."""
    return 2 * D + F * D + 2 * F * F + 5 * F + 1


# Bytes: each input read once, each output written once.
def k3_bytes(B: int, n: int, F: int, D: int, itemsize: int) -> int:
    """a_i, a_j, dist and the weights in; nm, mag out."""
    return itemsize * (3 * B * n * F + 2 * B * n * n
                       + n_weight_elements(F, D))


def k4_bytes(B: int, n: int, F: int, D: int, itemsize: int) -> int:
    """The K3 inputs and three tangents in; nm, mag, dnm, dmag out."""
    return itemsize * (6 * B * n * F + 4 * B * n * n
                       + n_weight_elements(F, D))


def k5_bytes(B: int, n: int, F: int, D: int, itemsize: int) -> int:
    """The K4 inputs and four cotangents in; six per-frame gradients and
    the eleven weight gradients out."""
    return itemsize * (10 * B * n * F + 6 * B * n * n
                       + 2 * n_weight_elements(F, D))


# Operations, counted from the kernels in csrc/egnn.cu: a multiply-add of
# a product counts two, every other arithmetic operation, comparison,
# select and transcendental one; loads, stores and index arithmetic none.
# Per pair: 2 (F D + 2 F^2) for K3's three products, twice that for K4's
# six, and 8 (F D + 2 F^2) more for K5's twelve transposed products; then
# the radial terms (per k), the per-feature and the per-pair terms.
def k3_ops(B: int, n: int, F: int, D: int) -> int:
    """Operations K3 does on B frames of n atoms."""
    per_pair = 2 * (F * D + 2 * F * F) + 12 * D + 28 * F + 10
    return B * n * n * per_pair


def k4_ops(B: int, n: int, F: int, D: int) -> int:
    """Operations K4 does on B frames of n atoms."""
    per_pair = 4 * (F * D + 2 * F * F) + 23 * D + 55 * F + 17
    return B * n * n * per_pair


def k5_ops(B: int, n: int, F: int, D: int) -> int:
    """Operations K5 does: the K4 recompute, the VJP, and the reduction
    of the weight gradients over the frames."""
    per_pair = (k4_ops(1, 1, F, D) + 8 * (F * D + 2 * F * F) + 82 * D
                + 102 * F + 22)
    return B * n * n * per_pair + B * n_weight_elements(F, D)


# =============================================================================
# Plain PyTorch versions
# =============================================================================

def _radial(dist, mu, log_gammas, r_cutoff):
    """Gaussians, the switching function and its first two derivatives,
    each ``(B, n, n, D)`` or ``(B, n, n, 1)``."""
    d = dist[..., None]
    gam = torch.exp(log_gammas)
    r = d - mu
    G = torch.exp(-gam * r * r)
    inside = d <= r_cutoff
    c = math.pi / r_cutoff
    S = torch.where(inside, 0.5 * torch.cos(c * d) + 0.5, 0.0)
    S1 = torch.where(inside, -0.5 * c * torch.sin(c * d), 0.0)
    S2 = torch.where(inside, -0.5 * c * c * torch.cos(c * d), 0.0)
    return gam, r, G, S, S1, S2


def _mask(dist, r_cutoff):
    n = dist.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)
    return ((~eye) & (dist <= r_cutoff)).to(dist.dtype)


def _silu_terms(x):
    """silu(x) and its first two derivatives."""
    sg = torch.sigmoid(x)
    return (x * sg, sg * (1.0 + x * (1.0 - sg)),
            sg * (1.0 - sg) * (2.0 + x * (1.0 - 2.0 * sg)))


def pairwise_reference(a_i, a_j, dist, mu, log_gammas, w_e, b1, w_m2, b_m2,
                       w_att, b_att, w_x1, b_x1, w_x2, r_cutoff: float):
    """Plain PyTorch version of K3, the contract of JAX's
    ``fused_egnn_pairwise``: returns ``(nm (B, n, F), mag (B, n, n))``."""
    mask = _mask(dist, r_cutoff)
    _, _, G, S, _, _ = _radial(dist, mu, log_gammas, r_cutoff)
    emb = G * S
    pre = a_i[:, :, None, :] + a_j[:, None, :, :] + emb @ w_e.T + b1
    s = torch.nn.functional.silu(pre)
    ms = torch.nn.functional.silu(s @ w_m2.T + b_m2)
    att = torch.sigmoid(ms @ w_att + b_att)
    msg = ms * (att * mask)[..., None]
    x1 = torch.nn.functional.silu(msg @ w_x1.T + b_x1)
    return msg.sum(dim=2), torch.tanh(x1 @ w_x2) * mask


def _jvp_chain(a_i, a_j, dist, mu, log_gammas, w_e, b1, w_m2, b_m2, w_att,
               b_att, w_x1, b_x1, w_x2, da_i, da_j, dd, r_cutoff):
    """The forward and tangent chain as K4 and K5 compute it, with every
    intermediate K5's VJP needs."""
    mask = _mask(dist, r_cutoff)
    gam, r, G, S, S1, _ = _radial(dist, mu, log_gammas, r_cutoff)
    emb = G * S
    ep = G * (S1 - 2.0 * gam * r * S)          # d emb / d dist
    demb = ep * dd[..., None]
    pre = a_i[:, :, None, :] + a_j[:, None, :, :] + emb @ w_e.T + b1
    dpre = da_i[:, :, None, :] + da_j[:, None, :, :] + demb @ w_e.T
    s, s1_pre, _ = _silu_terms(pre)
    ds = s1_pre * dpre
    m1 = s @ w_m2.T + b_m2
    dm1 = ds @ w_m2.T
    ms, s1_m1, _ = _silu_terms(m1)
    dms = s1_m1 * dm1
    att = torch.sigmoid(ms @ w_att + b_att)
    dv = dms @ w_att
    satt = att * (1.0 - att)
    datt = satt * dv
    msg = ms * (att * mask)[..., None]
    dmsg = (dms * att[..., None] + ms * datt[..., None]) * mask[..., None]
    z1 = msg @ w_x1.T + b_x1
    dz1 = dmsg @ w_x1.T
    x1, s1_z1, _ = _silu_terms(z1)
    dx1 = s1_z1 * dz1
    t = torch.tanh(x1 @ w_x2)
    q = dx1 @ w_x2
    return dict(mask=mask, gam=gam, emb=emb, ep=ep, demb=demb, pre=pre,
                dpre=dpre, s=s, ds=ds, m1=m1, dm1=dm1, ms=ms, dms=dms,
                att=att, dv=dv, satt=satt, datt=datt, msg=msg, dmsg=dmsg,
                z1=z1, dz1=dz1, x1=x1, dx1=dx1, t=t, q=q)


def pairwise_jvp_reference(a_i, a_j, dist, mu, log_gammas, w_e, b1, w_m2,
                           b_m2, w_att, b_att, w_x1, b_x1, w_x2, da_i, da_j,
                           dd, r_cutoff: float):
    """Plain PyTorch version of K4: ``(nm, mag, dnm, dmag)``, the primal
    outputs and their tangents for the tangents ``da_i``, ``da_j``, ``dd``
    of ``a_i``, ``a_j``, ``dist`` (the weights' tangents are zero)."""
    c = _jvp_chain(a_i, a_j, dist, mu, log_gammas, w_e, b1, w_m2, b_m2,
                   w_att, b_att, w_x1, b_x1, w_x2, da_i, da_j, dd, r_cutoff)
    return (c['msg'].sum(dim=2), c['t'] * c['mask'], c['dmsg'].sum(dim=2),
            (1.0 - c['t'] * c['t']) * c['q'] * c['mask'])


def pairwise_jvp_backward_reference(a_i, a_j, dist, mu, log_gammas, w_e, b1,
                                    w_m2, b_m2, w_att, b_att, w_x1, b_x1,
                                    w_x2, da_i, da_j, dd, r_cutoff, g_nm,
                                    g_mag, g_dnm, g_dmag):
    """Plain PyTorch version of K5: the VJP of :func:`pairwise_jvp_reference`
    for the cotangents of ``(nm, mag, dnm, dmag)``, derived by hand as the
    kernel computes it.

    Returns the 17 gradients in argument order: ``a_i, a_j, dist``, the
    eleven weights, then ``da_i, da_j, dd``.
    """
    c = _jvp_chain(a_i, a_j, dist, mu, log_gammas, w_e, b1, w_m2, b_m2,
                   w_att, b_att, w_x1, b_x1, w_x2, da_i, da_j, dd, r_cutoff)
    mask, t, q = c['mask'], c['t'], c['q']
    bsum = (0, 1, 2)

    # mag = t mask, dmag = (1 - t^2) q mask, t = tanh(u).
    gq = g_dmag * mask * (1.0 - t * t)
    gt = g_dmag * mask * q * (-2.0 * t) + g_mag * mask
    gu = gt * (1.0 - t * t)
    g_w_x2 = torch.einsum('bij,bijf->f', gq, c['dx1']) \
        + torch.einsum('bij,bijf->f', gu, c['x1'])
    # x1 = silu(z1), dx1 = silu'(z1) dz1.
    _, s1, s2 = _silu_terms(c['z1'])
    gdz1 = gq[..., None] * w_x2 * s1
    gz1 = gq[..., None] * w_x2 * c['dz1'] * s2 + gu[..., None] * w_x2 * s1
    g_b_x1 = gz1.sum(dim=bsum)
    g_w_x1 = torch.einsum('bijf,bijg->fg', gdz1, c['dmsg']) \
        + torch.einsum('bijf,bijg->fg', gz1, c['msg'])
    gdmsg = g_dnm[:, :, None, :] + gdz1 @ w_x1
    gmsg = g_nm[:, :, None, :] + gz1 @ w_x1
    # msg = ms att mask, dmsg = (dms att + ms datt) mask.
    att, satt, datt, dv = c['att'], c['satt'], c['datt'], c['dv']
    ms, dms = c['ms'], c['dms']
    gdatt = mask * (gdmsg * ms).sum(-1)
    gatt = mask * (gdmsg * dms + gmsg * ms).sum(-1)
    gdv = gdatt * satt
    gv = gdatt * satt * (1.0 - 2.0 * att) * dv + gatt * satt
    g_w_att = torch.einsum('bij,bijf->f', gdv, dms) \
        + torch.einsum('bij,bijf->f', gv, ms)
    g_b_att = gv.sum().reshape(1)
    gdms = (mask * att)[..., None] * gdmsg + gdv[..., None] * w_att
    gms = mask[..., None] * (datt[..., None] * gdmsg + att[..., None] * gmsg) \
        + gv[..., None] * w_att
    _, s1, s2 = _silu_terms(c['m1'])
    gdm1 = gdms * s1
    gm1 = gdms * c['dm1'] * s2 + gms * s1
    g_w_m2 = torch.einsum('bijf,bijg->fg', gdm1, c['ds']) \
        + torch.einsum('bijf,bijg->fg', gm1, c['s'])
    g_b_m2 = gm1.sum(dim=bsum)
    _, s1, s2 = _silu_terms(c['pre'])
    gds = gdm1 @ w_m2
    gs = gm1 @ w_m2
    gdpre = gds * s1
    gpre = gds * c['dpre'] * s2 + gs * s1
    g_b1 = gpre.sum(dim=bsum)
    g_a_i, g_a_j = gpre.sum(dim=2), gpre.sum(dim=1)
    g_da_i, g_da_j = gdpre.sum(dim=2), gdpre.sum(dim=1)
    g_w_e = torch.einsum('bijf,bijk->fk', gdpre, c['demb']) \
        + torch.einsum('bijf,bijk->fk', gpre, c['emb'])
    gdemb = gdpre @ w_e
    gemb = gpre @ w_e
    # The radial terms: emb = G S, ep = G (S1 - 2 gam r S) = d emb / d d.
    gam, r, G, S, S1, S2 = _radial(dist, mu, log_gammas, r_cutoff)
    ep = c['ep']
    gep = gdemb * dd[..., None]
    g_dd = (gdemb * ep).sum(-1)
    dep_dd = G * (S2 - 4.0 * gam * r * S1 + (4.0 * gam * gam * r * r
                                              - 2.0 * gam) * S)
    dep_dmu = G * (2.0 * gam * r * S1 - 4.0 * gam * gam * r * r * S
                   + 2.0 * gam * S)
    dep_dlg = gam * G * (-r * r * S1 + 2.0 * gam * r * r * r * S
                         - 2.0 * r * S)
    g_dist = (gemb * ep + gep * dep_dd).sum(-1)
    g_mu = (gemb * 2.0 * gam * r * G * S + gep * dep_dmu).sum(dim=bsum)
    g_lg = (gemb * (-gam * r * r * G * S) + gep * dep_dlg).sum(dim=bsum)
    return (g_a_i, g_a_j, g_dist, g_mu, g_lg, g_w_e, g_b1, g_w_m2, g_b_m2,
            g_w_att, g_b_att, g_w_x1, g_b_x1, g_w_x2, g_da_i, g_da_j, g_dd)


# =============================================================================
# Build and bind the CUDA kernels
# =============================================================================

_SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'egnn.cu'
_BUILD = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
_LIB = []
# The C functions' status when the block does not fit shared memory.
_NO_FIT = -1


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = Path(home) / 'bin' / 'nvcc'
    if path.exists():
        return str(path)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc was not found (looked in $CUDA_HOME/bin, '
                           '/usr/local/cuda/bin and PATH): the EGNN kernels '
                           'cannot be built.')
    return found


def build() -> Path:
    """Compile ``csrc/egnn.cu`` for sm_90a unless this source's library is
    built already; returns the library's path. ``ptxas`` reports each
    kernel's registers and spills in a ``.ptxas.txt`` file beside it."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    lib = _BUILD / f'libtfep_egnn_{digest}.so'
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
           '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
           '-Xptxas', '-v', '-o', str(tmp), str(_SOURCE)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f'nvcc failed ({done.returncode}):\n'
                           f'{done.stdout}\n{done.stderr}')
    lib.with_suffix('.ptxas.txt').write_text(done.stdout + done.stderr)
    os.replace(tmp, lib)
    return lib


def _library():
    if _LIB:
        return _LIB[0]
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ('egnn_k3', 'egnn_k4', 'egnn_k5'):
        fn = getattr(lib, name)
        # dtype (0 float32, 1 float64), device, input pointers, output
        # pointers, scratch, B, n, F, D, r_cutoff, stream.
        fn.argtypes = [i32, i32, ptr, ptr, ptr, i32, i32, i32, i32,
                       ctypes.c_double, ptr]
        fn.restype = i32
    lib.egnn_error_string.argtypes = [i32]
    lib.egnn_error_string.restype = ctypes.c_char_p
    _LIB.append(lib)
    return lib


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _launch(name, inputs, outputs, scratch, r_cutoff):
    lib = _library()
    a_i, w_e = inputs[0], inputs[5]
    B, n, F = a_i.shape
    D = w_e.shape[1]
    dtype = {torch.float32: 0, torch.float64: 1}[a_i.dtype]
    status = getattr(lib, name)(
        dtype, a_i.device.index, _pointers(inputs), _pointers(outputs),
        None if scratch is None else scratch.data_ptr(), B, n, F, D,
        float(r_cutoff), torch.cuda.current_stream(a_i.device).cuda_stream)
    if status == _NO_FIT:
        raise ValueError(f'{name}: a block for n={n}, F={F}, D={D} does not '
                         'fit the card\'s shared memory.')
    if status != 0:
        raise RuntimeError(f'{name} failed to launch: '
                           f'{lib.egnn_error_string(status).decode()}')


def _require_cuda(tensors, n_tangents):
    """What :func:`_check` checks, and that every tensor is on the card."""
    _check(tensors[:14 + n_tangents], n_tangents)
    for t in tensors:
        if t.device.type != 'cuda' or not t.is_contiguous():
            raise ValueError('The EGNN kernels take contiguous CUDA '
                             f'tensors, got one on {t.device}.')


def launch_k3(a_i, a_j, dist, *weights, r_cutoff):
    """Launch K3 on CUDA tensors; returns ``(nm, mag)``. The one place that
    counts K3's launches."""
    inputs = (a_i, a_j, dist, *weights)
    _require_cuda(inputs, 0)
    nm = torch.empty_like(a_i)
    mag = torch.empty_like(dist)
    _launch('egnn_k3', inputs, (nm, mag), None, r_cutoff)
    LAUNCHES.k3 += 1
    return nm, mag


def launch_k4(a_i, a_j, dist, *weights_and_tangents, r_cutoff):
    """Launch K4 on CUDA tensors (the 14 primals, then the tangents of
    ``a_i``, ``a_j``, ``dist``); returns ``(nm, mag, dnm, dmag)``. The one
    place that counts K4's launches."""
    inputs = (a_i, a_j, dist, *weights_and_tangents)
    _require_cuda(inputs, 3)
    outs = (torch.empty_like(a_i), torch.empty_like(dist),
            torch.empty_like(a_i), torch.empty_like(dist))
    _launch('egnn_k4', inputs, outs, None, r_cutoff)
    LAUNCHES.k4 += 1
    return outs


def launch_k5(*args, r_cutoff):
    """Launch K5 on CUDA tensors: the 17 inputs of K4, then the cotangents
    of ``(nm, mag, dnm, dmag)``. Returns the 17 gradients in argument
    order. The one place that counts K5's launches."""
    _require_cuda(args, 3)
    a_i, dist, w_e = args[0], args[2], args[5]
    B, n, F = a_i.shape
    D = w_e.shape[1]
    for name, g, like in zip(('g_nm', 'g_mag', 'g_dnm', 'g_dmag'), args[17:],
                             (a_i, dist, a_i, dist)):
        if g.shape != like.shape or g.dtype != like.dtype:
            raise ValueError(f'{name} must match the output it is the '
                             f'cotangent of: {tuple(like.shape)}, '
                             f'{like.dtype}.')
    if len(args) != 21:
        raise ValueError(f'launch_k5 takes 21 tensors, got {len(args)}.')
    nw = n_weight_elements(F, D)
    # Per-block weight-gradient sums, then their reduction over frames.
    scratch = torch.empty(B * nw, dtype=a_i.dtype, device=a_i.device)
    flat = torch.empty(nw, dtype=a_i.dtype, device=a_i.device)
    frame = [torch.empty_like(a_i), torch.empty_like(a_i),
             torch.empty_like(dist), torch.empty_like(a_i),
             torch.empty_like(a_i), torch.empty_like(dist)]
    _launch('egnn_k5', args, (*frame, flat), scratch, r_cutoff)
    LAUNCHES.k5 += 1
    weights, start = [], 0
    for shape in _weight_shapes(F, D):
        size = math.prod(shape)
        weights.append(flat[start:start + size].view(shape))
        start += size
    return (*frame[:3], *weights, *frame[3:])


# =============================================================================
# Wrappers
# =============================================================================

def _check(args, n_tangents):
    """Shapes, types, devices and contiguity of the 14 primal arguments
    and the tangents of ``a_i``, ``a_j``, ``dist``."""
    a_i = args[0]
    if a_i.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'The EGNN block takes float32 or float64, not '
                        f'{a_i.dtype}.')
    if a_i.ndim != 3 or a_i.numel() == 0:
        raise ValueError(f'a_i must be a non-empty (batch, n, feat) tensor, '
                         f'got shape {tuple(a_i.shape)}.')
    B, n, F = a_i.shape
    D = args[5].shape[-1]
    shapes = ((B, n, F), (B, n, F), (B, n, n), *_weight_shapes(F, D))
    shapes += shapes[:3][:n_tangents]
    names = ('a_i', 'a_j', 'dist') + WEIGHTS + ('da_i', 'da_j', 'dd')
    for name, t, shape in zip(names, args, shapes):
        if t.dtype != a_i.dtype or t.device != a_i.device:
            raise TypeError(f'{name} must match a_i in dtype and device '
                            f'({a_i.dtype}, {a_i.device}), got {t.dtype}, '
                            f'{t.device}.')
        if tuple(t.shape) != shape:
            raise ValueError(f'{name} must have shape {shape}, got '
                             f'{tuple(t.shape)}.')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous.')
    if a_i.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'The EGNN block runs on cuda or cpu tensors, not '
                         f'{a_i.device}.')


class _EGNNPairwiseJVP(torch.autograd.Function):
    """Port of ``_jvp_op``: K4 forward, K5 backward (first order).

    Inputs: the 14 primals, the tangents of ``a_i``, ``a_j``, ``dist``,
    then ``r_cutoff``. Outputs: ``(nm, mag, dnm, dmag)``.
    """

    @staticmethod
    def forward(ctx, *args):
        arrays, r_cutoff = args[:17], args[17]
        ctx.save_for_backward(*arrays)
        ctx.r_cutoff = r_cutoff
        if arrays[0].device.type == 'cpu':
            return pairwise_jvp_reference(*arrays, r_cutoff)
        return launch_k4(*arrays, r_cutoff=r_cutoff)

    @staticmethod
    def backward(ctx, g_nm, g_mag, g_dnm, g_dmag):
        arrays = ctx.saved_tensors
        cots = [g.contiguous() for g in (g_nm, g_mag, g_dnm, g_dmag)]
        if arrays[0].device.type == 'cpu':
            grads = pairwise_jvp_backward_reference(*arrays, ctx.r_cutoff,
                                                    *cots)
        else:
            grads = launch_k5(*arrays, *cots, r_cutoff=ctx.r_cutoff)
        return (*grads, None)


def egnn_pairwise_jvp(a_i, a_j, dist, mu, log_gammas, w_e, b1, w_m2, b_m2,
                      w_att, b_att, w_x1, b_x1, w_x2, da_i, da_j, dd,
                      r_cutoff: float):
    """Primal and tangent of the pairwise block (K4; K5 for its gradient).

    Differentiable in reverse mode with respect to every argument. On a
    CUDA tensor it launches the kernels; on a CPU tensor it runs
    :func:`pairwise_jvp_reference` and, backward,
    :func:`pairwise_jvp_backward_reference`.

    Parameters
    ----------
    a_i, a_j : torch.Tensor, shape (batch, n, feat)
        Factored first-layer message terms ``h W_i^T`` (receiver) and
        ``h W_j^T`` (sender).
    dist : torch.Tensor, shape (batch, n, n)
        Safe pairwise distances (diagonal 1).
    mu, log_gammas : (d_feat,); w_e : (feat, d_feat); b1 : (feat,)
    w_m2 : (feat, feat); b_m2 : (feat,); w_att : (feat,); b_att : (1,)
    w_x1 : (feat, feat); b_x1 : (feat,); w_x2 : (feat,)
        The layer's weights, as JAX's ``fused_egnn_pairwise`` takes them.
    da_i, da_j, dd : torch.Tensor
        Tangents of ``a_i``, ``a_j``, ``dist``.
    r_cutoff : float

    Returns
    -------
    nm, mag, dnm, dmag : torch.Tensor
        ``(batch, n, feat)``, ``(batch, n, n)`` and their tangents.
    """
    args = (a_i, a_j, dist, mu, log_gammas, w_e, b1, w_m2, b_m2, w_att,
            b_att, w_x1, b_x1, w_x2, da_i, da_j, dd)
    _check(args, 3)
    return _EGNNPairwiseJVP.apply(*args, float(r_cutoff))


def egnn_pairwise(a_i, a_j, dist, mu, log_gammas, w_e, b1, w_m2, b_m2,
                  w_att, b_att, w_x1, b_x1, w_x2, r_cutoff: float):
    """The pairwise block's primal outputs ``(nm, mag)`` (K3), without a
    gradient, as JAX's ``fused_egnn_pairwise`` outside a ``jvp``.

    Arguments as :func:`egnn_pairwise_jvp`, without the tangents. Raises
    if gradients are enabled and an argument requires one: the gradient
    of the block exists only through :func:`egnn_pairwise_jvp`.
    """
    args = (a_i, a_j, dist, mu, log_gammas, w_e, b1, w_m2, b_m2, w_att,
            b_att, w_x1, b_x1, w_x2)
    _check(args, 0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError(
            'The fused EGNN block has no gradient of its plain forward: '
            'differentiate forward_and_jvp (the CNF pattern), use '
            "pairwise='dense', or call under torch.no_grad().")
    if a_i.device.type == 'cpu':
        return pairwise_reference(*args, r_cutoff)
    return launch_k3(*args, r_cutoff=float(r_cutoff))
