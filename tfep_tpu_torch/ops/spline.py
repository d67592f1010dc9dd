"""Fused rational-quadratic spline: Triton kernels for Hopper (forward, backward).

Replaces the Pallas TPU kernels of ``tfep_tpu/ops/pallas/spline.py``:
``_forward_kernel`` (K1, reached through ``_fused_spline_fwd_impl``) and
``_backward_kernel`` (K2, reached through ``_fused_spline_bwd``). For the
standard spline configuration (non-circular, fixed domain, K+1 free
slopes) K1 maps each element ``(b, f)``: softmax of its K width and K height
logits, K+1 slopes ``softplus(s + offset) + min_slope``, the knots, and the
rational-quadratic map with its ``log dy/dx`` in the element's bin (the
bin-relative position clamped to [0, 1]), with linear tails outside
``[x0, xf]``. K2 recomputes that and writes the analytic gradients with
respect to ``x`` and all 3K+1 raw parameters.

What bounds them on an H100: device memory. Every element reads its own
3K+1 parameters once and no thread cooperates with another, so the least
time is the bytes over the card's bandwidth. At the bench shape (B=4096,
F=96, K=8, float32) K1 moves x, params, the four bound rows, y and dl:
about 44.0 MB. K2 moves x, params, gy, gl, gx and gparams: about 84.9 MB.

Design of K1. One program owns a ``(BLOCK_B, BLOCK_F)`` tile, one element
per thread, and walks the K bins in an unrolled ``tl.static_range`` loop,
so each parameter row is loaded coalesced along F. Unlike the TPU kernels,
which evaluate every bin in every lane and mask afterwards, a thread
selects its own bin's width, height, knots and slopes with a running
``tl.where`` and evaluates the map once (the clamp of ``e`` is kept).

Design of K2. It is bound by device memory as K1 is, but only if its
instructions keep up: per element it redoes K1's softmax statistics and
bin walk and writes 3K+2 gradients. Done pass by pass as K1 is, that
would load each width and height logit four times and exponentiate it
three times, load each slope twice, and take about as long in
instructions as in bytes. So K2 holds an element's 3K+1 parameters in
registers: its tile is a ``(BLOCK_B, KP, BLOCK_F)`` block, bins on the
middle axis (KP = K rounded up to a power of two, the padded bins
masked: logits read as ``-inf``, their gradients not stored), and with
one element per thread of the tile the bins stay in that thread, so the
maxima, sums and prefix sums over them need no other thread. Each
parameter is loaded once, each exponential is taken once and kept for
the gradients, each softmax sum gives one reciprocal, and one
``exp(-|z|)`` and one reciprocal per slope give both the softplus (with
``log1p`` corrected to first order) and the sigmoid of its gradient. The
element's bin is the number of inner knots at or below it (bin 0 below
the domain), and its quantities are picked out with masked sums. The TPU
kernel's suffix sums over the cumulative offsets become "add this
element's offset gradient to every bin below its own". B and F are not
specialised, so accesses stay 4-byte: 16-byte ones need four elements a
thread, whose registers spill. What is left is the access pattern's:
``tfep_tpu_torch/tools/spline_k2_probe.py`` times K2 beside a copy with
its grid, tile and bytes.

Kinds. Both kernels take three more spline configurations of the
transformer, as ``tl.constexpr`` specialisations of the same source (the
standard one compiles to the arithmetic above, unchanged), chosen by
``kind`` (:data:`KINDS`):

- ``identity_upper`` (distances): both boundary slopes pinned to
  ``softplus(offset) + min_slope`` (1 up to rounding), K-1 free inner
  slopes, and a learned upper bound: ``exp`` of the element's last
  parameter scales the width and height of the domain above ``x0``,
  ``y0``, and so where the upper tail starts and ends.
- ``circular`` (torsions): K free slopes, slope K tied to slope 0, and a
  learned shift, the last parameter: the spline maps ``(x - x0 + shift)
  mod (xf - x0) + x0``, whose derivative with respect to ``x`` and to the
  shift is 1.
- ``circular_identity``: the circular spline with both boundary slopes
  pinned.

Each kind reads its ``NP`` parameter rows per feature (3K+1, 3K, 3K+1, 3K)
from rows that may be a strided view (``P_STRIDE`` elements from one row
to the next, the features contiguous), so a group's slice of a wider
conditioner output is read in place; K2 writes a contiguous gradient.

There is no feature padding and no batch tiling constraint: ragged B and F
edges are masked. Triton compiles both kernels at their first launch from
this source, into ``TRITON_CACHE_DIR`` (default ``build/triton`` of the
checkout), once for each kind.

The wrapper :func:`fused_spline` launches the kernels for CUDA tensors and
runs :func:`fused_spline_reference`, the plain PyTorch version of the same
math, only for CPU tensors.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from tfep_tpu_torch.ops import LaunchCounter, fold_members, unfold_members

__all__ = ['fused_spline', 'fused_spline_reference', 'LAUNCHES', 'KINDS',
           'n_parameters', 'softplus', 'spline_offset', 'launch_forward',
           'launch_backward', 'forward_bytes', 'backward_bytes',
           'forward_ops', 'backward_ops']

# The spline configurations the kernels take: (identity boundary slopes,
# learned upper bound, circular with a learned shift).
KINDS = {
    'standard': (False, False, False),
    'identity_upper': (True, True, False),
    'circular': (False, False, True),
    'circular_identity': (True, False, True),
}


def _free_slopes(kind: str, K: int) -> int:
    """K+1 knot slopes, less the two pinned boundary slopes, or less the
    last where it is tied to the first."""
    identity, _, circular = KINDS[kind]
    return K - 1 if identity else K if circular else K + 1


def n_parameters(kind: str, K: int) -> int:
    """Raw parameters per feature of ``kind``: K width and K height
    logits, the free slopes, then a scale or a shift."""
    _, scale, circular = KINDS[kind]
    return 2 * K + _free_slopes(kind, K) + int(scale) + int(circular)


def forward_bytes(B: int, F: int, K: int, itemsize: int,
                  kind: str = 'standard') -> int:
    """Least bytes K1 moves: x, params and 4 bound rows in; y, dl out."""
    P = n_parameters(kind, K)
    return itemsize * (B * F + B * P * F + 4 * F + 2 * B * F)


def backward_bytes(B: int, F: int, K: int, itemsize: int,
                   kind: str = 'standard') -> int:
    """Least bytes K2 moves: x, params, 4 bound rows, gy, gl in; gx,
    gparams out."""
    P = n_parameters(kind, K)
    return itemsize * (3 * B * F + 2 * B * P * F + 4 * F + B * F)


# Operations per element, counted from the kernels below: each arithmetic
# operation, comparison, select and transcendental once; loads, stores and
# index arithmetic not at all.
def forward_ops(B: int, F: int, K: int) -> int:
    """Operations K1 does on a (B, F) input with K bins."""
    return B * F * (44 * K + 62)


def backward_ops(B: int, F: int, K: int) -> int:
    """Operations K2 does on a (B, F) input with K bins (the K real bins,
    not the padding of its tile): per bin 10 for the softmax statistics
    and probabilities, 16 per slope (softplus and sigmoid), 34 for the bin
    walk and the masked sums that pick the element's bin, 20 for the
    gradients written, 1 for the slope's offset; per element 125 for the
    bin's gradients and 34 besides."""
    return B * F * (81 * K + 159)


# K1's and K2's launches, and each kind's (``forward_circular``, ...).
LAUNCHES = LaunchCounter('forward', 'backward', *(
    f'{direction}_{kind}' for kind in KINDS
    for direction in ('forward', 'backward')))

# K1's tile.
BLOCK_B = 4
BLOCK_F = 32
NUM_WARPS = 4
# K2's tile, with as many elements as threads: fewer and the bins would
# spread over threads, more and a thread would hold several elements'
# 3K+1 parameters in registers.
BACKWARD_LAYOUT = dict(BLOCK_B=4, BLOCK_F=32, num_warps=4)

# Compiled kernels, built at the first launch (Triton is imported there).
_KERNELS = {}
# (device, dtype, min_bin_size, min_slope) -> constants tensor on the card.
_CONSTANTS = {}


def spline_offset(min_slope: float) -> float:
    """Slope pre-activation offset: zero parameters give slope exactly 1."""
    return float(np.log(np.exp(1.0 - min_slope) - 1.0))


# =============================================================================
# Plain PyTorch version
# =============================================================================

def softplus(z):
    """``log(1 + exp(z))`` as JAX computes it (``logaddexp(z, 0)``).

    ``torch.nn.functional.softplus`` returns ``z`` above its threshold of
    20, which differs from JAX there.
    """
    return torch.logaddexp(z, torch.zeros_like(z))


def fused_spline_reference(x, params, x0, xf, y0, yf, n_bins: int,
                           min_bin_size: float = 1e-4,
                           min_slope: float = 1e-4, kind: str = 'standard'):
    """Plain PyTorch version of the kernels' function, element by element.

    Follows the kernel's math: softmax, softplus with offset, the per-bin
    rational-quadratic map under a mask with the clamp of the bin-relative
    position, and linear tails outside ``[x0, xf]``; for the other kinds
    the pinned or tied slopes, the domain scale and the shift. Its
    autograd is the reference for K2. Arguments as :func:`fused_spline`.

    Returns
    -------
    y, log_dy_dx : torch.Tensor, shape (batch, n_features)
    """
    K = n_bins
    B, F = x.shape
    identity, scale, circular = KINDS[kind]
    p = params.reshape(B, n_parameters(kind, K), F)
    R_w = (xf - x0) - K * min_bin_size
    R_h = (yf - y0) - K * min_bin_size
    W = xf - x0
    xr = x - x0
    if scale:
        domain_scale = torch.exp(p[:, -1])
        R_w = R_w * domain_scale
        R_h = R_h * domain_scale
        W = R_w + K * min_bin_size
        yf = y0 + R_h + K * min_bin_size
    if circular:
        xr = torch.remainder(xr + p[:, -1], W)
    raw = p[:, 2 * K:2 * K + _free_slopes(kind, K)]
    if identity:
        zero = torch.zeros_like(raw[:, :1])
        raw = torch.cat([zero, raw, zero], dim=1)
    elif circular:
        raw = torch.cat([raw, raw[:, :1]], dim=1)
    R_w, R_h = R_w.unsqueeze(-2), R_h.unsqueeze(-2)
    widths = torch.softmax(p[:, :K], dim=1) * R_w + min_bin_size
    heights = torch.softmax(p[:, K:2 * K], dim=1) * R_h + min_bin_size
    slopes = softplus(raw + spline_offset(min_slope)) + min_slope

    zero = torch.zeros_like(widths[:, :1])
    cw = torch.cat([zero, torch.cumsum(widths[:, :-1], dim=1)], dim=1)
    ch = torch.cat([zero, torch.cumsum(heights[:, :-1], dim=1)], dim=1)
    xr = xr[:, None]
    in_bin = xr >= cw
    in_bin = torch.cat([in_bin[:, :-1] & (xr < cw + widths)[:, :-1],
                        in_bin[:, -1:]], dim=1)

    e = torch.clamp((xr - cw) / widths, 0.0, 1.0)
    sb = heights / widths
    emo = e * (1.0 - e)
    s_k, s_k1 = slopes[:, :-1], slopes[:, 1:]
    c = s_k1 + s_k - 2.0 * sb
    A = sb * e * e + s_k * emo
    D = sb + c * emo
    y_k = y0 + ch + heights * A / D
    N = s_k1 * e * e + 2.0 * sb * emo + s_k * (1.0 - e) ** 2
    dl_k = torch.log(sb * sb * N / (D * D))
    y = torch.sum(torch.where(in_bin, y_k, 0.0), dim=1)
    dl = torch.sum(torch.where(in_bin, dl_k, 0.0), dim=1)

    xr = xr[:, 0]
    below = xr < 0.0
    above = xr >= W
    y = torch.where(below, y0 + slopes[:, 0] * xr, y)
    dl = torch.where(below, torch.log(slopes[:, 0]), dl)
    y = torch.where(above, yf + slopes[:, -1] * (xr - W), y)
    dl = torch.where(above, torch.log(slopes[:, -1]), dl)
    return y, dl


# =============================================================================
# Triton kernels
# =============================================================================

def _kernels():
    """Import Triton and define the two kernels (once per process).

    The kernels reference ``tl`` and their helper as module globals, which
    is where Triton's compiler looks names up; binding them here keeps
    Triton out of the import of this module, so a machine without Triton
    (and without a card) can import it and run the plain version.
    """
    if _KERNELS:
        return _KERNELS
    global tl, _softplus_tl, _slope_tl, _bins_sum, _period_tl
    build = Path(__file__).resolve().parents[2] / 'build'
    os.environ.setdefault('TRITON_CACHE_DIR', str(build / 'triton'))
    os.environ.setdefault('TRITON_HOME', str(build))
    import triton
    import triton.language as tl

    @triton.jit
    def _softplus_tl(z):
        # max(z, 0) + log1p(exp(-|z|)), with log1p(t) = log(u) * t / (u - 1)
        # for u = 1 + t (exact where u rounds to 1): Triton has no log1p.
        t = tl.exp(-tl.abs(z))
        u = 1.0 + t
        lp = tl.where(u == 1.0, t, tl.log(u) * t / (u - 1.0))
        return tl.maximum(z, 0.0) + lp

    @triton.jit
    def _period_tl(t, period):
        # torch.remainder(t, period) for period > 0, in [0, period) also
        # where the quotient rounded across a whole number.
        r = t - tl.floor(t / period) * period
        r = tl.where(r < 0.0, r + period, r)
        return tl.where(r >= period, r - period, r)

    @triton.jit
    def forward_kernel(x_ptr, p_ptr, x0_ptr, xf_ptr, y0_ptr, yf_ptr, c_ptr,
                       y_ptr, dl_ptr, B, F, P_STRIDE, K: tl.constexpr,
                       BLOCK_B: tl.constexpr, BLOCK_F: tl.constexpr,
                       NP: tl.constexpr, IDENTITY: tl.constexpr,
                       SCALE: tl.constexpr, CIRCULAR: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
        cols = tl.program_id(1) * BLOCK_F + tl.arange(0, BLOCK_F)
        cmask = cols < F
        m = (rows < B)[:, None] & cmask[None, :]
        xy = rows[:, None] * F + cols[None, :]
        pb = p_ptr + rows[:, None] * P_STRIDE + cols[None, :]
        min_bin = tl.load(c_ptr)
        min_slope = tl.load(c_ptr + 1)
        offset = tl.load(c_ptr + 2)

        x = tl.load(x_ptr + xy, mask=m, other=0.0)
        x0 = tl.load(x0_ptr + cols, mask=cmask, other=0.0)[None, :]
        xf = tl.load(xf_ptr + cols, mask=cmask, other=1.0)[None, :]
        y0 = tl.load(y0_ptr + cols, mask=cmask, other=0.0)[None, :]
        yf = tl.load(yf_ptr + cols, mask=cmask, other=1.0)[None, :]
        R_w = (xf - x0) - K * min_bin
        R_h = (yf - y0) - K * min_bin
        xr = x - x0
        W = xf - x0
        if SCALE:
            # The learned upper bound: the last row's exp scales the
            # domain above x0 and y0.
            scale = tl.exp(tl.load(pb + (NP - 1) * F, mask=m, other=0.0))
            R_w = R_w * scale
            R_h = R_h * scale
            W = R_w + K * min_bin
            yf = y0 + R_h + K * min_bin
        if CIRCULAR:
            # The learned shift, the last row, then the period.
            xr = _period_tl(xr + tl.load(pb + (NP - 1) * F, mask=m,
                                         other=0.0), W)

        # Softmax statistics of the width and height logits.
        w_max = tl.load(pb, mask=m, other=0.0)
        h_max = tl.load(pb + K * F, mask=m, other=0.0)
        for k in tl.static_range(1, K):
            w_max = tl.maximum(w_max, tl.load(pb + k * F, mask=m, other=0.0))
            h_max = tl.maximum(h_max, tl.load(pb + (K + k) * F, mask=m,
                                              other=0.0))
        w_sum = tl.zeros_like(x)
        h_sum = tl.zeros_like(x)
        for k in tl.static_range(K):
            w_sum += tl.exp(tl.load(pb + k * F, mask=m, other=0.0) - w_max)
            h_sum += tl.exp(tl.load(pb + (K + k) * F, mask=m, other=0.0)
                            - h_max)

        # Walk the bins; keep the element's own bin (bin 0 when below).
        # Slope k is on row 2K + k, or 2K + k - 1 where slope 0 is pinned.
        if IDENTITY:
            s_lo = tl.zeros_like(x) + tl.load(c_ptr + 3)
        else:
            s_lo = _softplus_tl(tl.load(pb + 2 * K * F, mask=m, other=0.0)
                                + offset) + min_slope
        s_first = s_lo
        cw = tl.zeros_like(x)
        ch = tl.zeros_like(x)
        for k in tl.static_range(K):
            w_k = (tl.exp(tl.load(pb + k * F, mask=m, other=0.0) - w_max)
                   / w_sum * R_w + min_bin)
            h_k = (tl.exp(tl.load(pb + (K + k) * F, mask=m, other=0.0)
                          - h_max) / h_sum * R_h + min_bin)
            if k < K - 1:
                s_hi = _softplus_tl(tl.load(
                    pb + (2 * K + k + 1 - IDENTITY) * F, mask=m, other=0.0)
                    + offset) + min_slope
            elif IDENTITY:
                s_hi = s_first   # pinned, as slope 0
            elif CIRCULAR:
                s_hi = s_first   # tied to slope 0
            else:
                s_hi = _softplus_tl(tl.load(pb + 3 * K * F, mask=m,
                                            other=0.0) + offset) + min_slope
            if k == 0:
                b_w = w_k
                b_h = h_k
                b_cw = cw
                b_ch = ch
                b_sk = s_lo
                b_sk1 = s_hi
            else:
                in_bin = xr >= cw
                if k < K - 1:
                    in_bin = in_bin & (xr < cw + w_k)
                b_w = tl.where(in_bin, w_k, b_w)
                b_h = tl.where(in_bin, h_k, b_h)
                b_cw = tl.where(in_bin, cw, b_cw)
                b_ch = tl.where(in_bin, ch, b_ch)
                b_sk = tl.where(in_bin, s_lo, b_sk)
                b_sk1 = tl.where(in_bin, s_hi, b_sk1)
            cw = cw + w_k
            ch = ch + h_k
            s_lo = s_hi
        s_last = s_lo

        rw = 1.0 / b_w
        e = tl.minimum(tl.maximum((xr - b_cw) * rw, 0.0), 1.0)
        sb = b_h * rw
        emo = e * (1.0 - e)
        c = b_sk1 + b_sk - 2.0 * sb
        A = sb * e * e + b_sk * emo
        D = sb + c * emo
        rD = 1.0 / D
        y = y0 + b_ch + b_h * A * rD
        N = b_sk1 * e * e + 2.0 * sb * emo + b_sk * (1.0 - e) * (1.0 - e)
        dl = tl.log(sb * sb * N * rD * rD)

        below = xr < 0.0
        above = xr >= W
        y = tl.where(below, y0 + s_first * xr, y)
        dl = tl.where(below, tl.log(s_first), dl)
        y = tl.where(above, yf + s_last * (xr - W), y)
        dl = tl.where(above, tl.log(s_last), dl)
        tl.store(y_ptr + xy, y, mask=m)
        tl.store(dl_ptr + xy, dl, mask=m)

    @triton.jit
    def _bins_sum(v):
        # Sum over the bins (axis 1), kept as an axis of size 1.
        return tl.expand_dims(tl.sum(v, axis=1), 1)

    @triton.jit
    def _slope_tl(z, min_slope):
        # softplus(z) + min_slope and sigmoid(z) from one t = exp(-|z|) and
        # one r = 1 / (1 + t): softplus = max(z, 0) + log1p(t), with
        # log1p(t) = log(u) + (t - (u - 1)) / u for u = 1 + t rounded (u - 1
        # is exact, so the second term restores what the rounding of u
        # lost; it is t where u rounds to 1). Triton has no log1p.
        t = tl.exp(-tl.abs(z))
        u = 1.0 + t
        r = 1.0 / u
        s = tl.maximum(z, 0.0) + tl.log(u) + (t - (u - 1.0)) * r + min_slope
        return s, tl.where(z >= 0.0, r, t * r)

    @triton.jit(do_not_specialize=['B', 'F', 'P_STRIDE'])
    def backward_kernel(x_ptr, p_ptr, x0_ptr, xf_ptr, y0_ptr, yf_ptr, c_ptr,
                        gy_ptr, gl_ptr, gx_ptr, gp_ptr, B, F, P_STRIDE,
                        K: tl.constexpr, KP: tl.constexpr,
                        BLOCK_B: tl.constexpr, BLOCK_F: tl.constexpr,
                        NP: tl.constexpr, IDENTITY: tl.constexpr,
                        SCALE: tl.constexpr, CIRCULAR: tl.constexpr):
        # Axes: rows, bins, features. Every tensor is 3-D so that all share
        # one layout; Triton orders the axes features, rows, bins, so with
        # BLOCK_B * BLOCK_F threads a thread holds all bins of its element.
        rows = (tl.program_id(0) * BLOCK_B
                + tl.arange(0, BLOCK_B))[:, None, None]
        cols = (tl.program_id(1) * BLOCK_F
                + tl.arange(0, BLOCK_F))[None, None, :]
        kk = tl.arange(0, KP)[None, :, None]
        cmask = cols < F
        m = (rows < B) & cmask
        mk = m & (kk < K)
        xy = rows * F + cols
        poff = rows * P_STRIDE + cols
        goff = rows * (NP * F) + cols
        pb = p_ptr + poff + kk * F
        gb = gp_ptr + goff + kk * F
        min_bin = tl.load(c_ptr)
        min_slope = tl.load(c_ptr + 1)
        offset = tl.load(c_ptr + 2)

        # Every input is read once: NP parameters, x, gy, gl per element.
        lw = tl.load(pb, mask=mk, other=-float('inf'))
        lh = tl.load(pb + K * F, mask=mk, other=-float('inf'))
        if IDENTITY:
            # Slopes 1..K-1 on rows 2K..3K-2; slopes 0 and K pinned.
            zs = tl.load(pb + (2 * K - 1) * F, mask=mk & (kk >= 1),
                         other=0.0) + offset
        else:
            zs = tl.load(pb + 2 * K * F, mask=mk, other=0.0) + offset
        if IDENTITY + CIRCULAR == 0:
            z_last = tl.load(p_ptr + poff + 3 * K * F, mask=m,
                             other=0.0) + offset
        x = tl.load(x_ptr + xy, mask=m, other=0.0)
        gy = tl.load(gy_ptr + xy, mask=m, other=0.0)
        gl = tl.load(gl_ptr + xy, mask=m, other=0.0)
        x0 = tl.load(x0_ptr + cols, mask=cmask, other=0.0)
        xf = tl.load(xf_ptr + cols, mask=cmask, other=1.0)
        y0 = tl.load(y0_ptr + cols, mask=cmask, other=0.0)
        yf = tl.load(yf_ptr + cols, mask=cmask, other=1.0)
        R_w = (xf - x0) - K * min_bin
        R_h = (yf - y0) - K * min_bin
        xr = x - x0
        W = xf - x0
        if SCALE:
            scale = tl.exp(tl.load(p_ptr + poff + (NP - 1) * F, mask=m,
                                   other=0.0))
            R_w = R_w * scale
            R_h = R_h * scale
            W = R_w + K * min_bin
        if CIRCULAR:
            xr = _period_tl(xr + tl.load(p_ptr + poff + (NP - 1) * F,
                                         mask=m, other=0.0), W)
        below = xr < 0.0
        above = xr >= W
        inside = (xr >= 0.0) & (xr < W)

        # Softmax probabilities (0 on the padded bins), one exponential per
        # logit and one reciprocal per sum; slopes 0..K-1, slope K.
        ew = tl.exp(lw - tl.expand_dims(tl.max(lw, axis=1), 1))
        pw = ew * (1.0 / _bins_sum(ew))
        eh = tl.exp(lh - tl.expand_dims(tl.max(lh, axis=1), 1))
        ph = eh * (1.0 / _bins_sum(eh))
        s, sig = _slope_tl(zs, min_slope)
        if IDENTITY:
            s_one = tl.load(c_ptr + 3)
            s = tl.where(kk == 0, s_one, s)
            s_last = tl.zeros_like(x) + s_one
        elif CIRCULAR:
            s_last = _bins_sum(tl.where(kk == 0, s, 0.0))
        else:
            s_last, sig_last = _slope_tl(z_last, min_slope)

        # The element's bin: the number of inner knots at or below it (bin
        # 0 below the domain, K-1 above it). cw, ch: right edges of the bins.
        cw = tl.cumsum(pw * R_w + min_bin, axis=1)
        ch = tl.cumsum(ph * R_h + min_bin, axis=1)
        b = _bins_sum(tl.where((kk < K - 1) & (xr >= cw), 1, 0))
        at = kk == b
        under = kk < b
        left = kk == b - 1
        b_pw = _bins_sum(tl.where(at, pw, 0.0))
        b_ph = _bins_sum(tl.where(at, ph, 0.0))
        b_w = b_pw * R_w + min_bin
        b_h = b_ph * R_h + min_bin
        b_cw = _bins_sum(tl.where(left, cw, 0.0))
        b_ch = _bins_sum(tl.where(left, ch, 0.0))
        b_cpw = _bins_sum(tl.where(under, pw, 0.0))
        b_cph = _bins_sum(tl.where(under, ph, 0.0))
        b_sk = _bins_sum(tl.where(at, s, 0.0))
        b_sk1 = tl.where(b == K - 1, s_last,
                         _bins_sum(tl.where(kk == b + 1, s, 0.0)))
        s_first = _bins_sum(tl.where(kk == 0, s, 0.0))

        # Analytic gradients of the element's bin (as the TPU kernel).
        rw = 1.0 / b_w
        e = tl.minimum(tl.maximum((xr - b_cw) * rw, 0.0), 1.0)
        sb = b_h * rw
        emo = e * (1.0 - e)
        one_m2e = 1.0 - 2.0 * e
        c = b_sk1 + b_sk - 2.0 * sb
        A = sb * e * e + b_sk * emo
        D = sb + c * emo
        N = b_sk1 * e * e + 2.0 * sb * emo + b_sk * (1.0 - e) * (1.0 - e)
        rD = 1.0 / D
        rN = 1.0 / N
        hrD2 = b_h * rD * rD

        dA_de = 2.0 * sb * e + b_sk * one_m2e
        dD_de = c * one_m2e
        dN_de = 2.0 * b_sk1 * e + 2.0 * sb * one_m2e - 2.0 * b_sk * (1.0 - e)
        ge = (gy * (hrD2 * (dA_de * D - A * dD_de))
              + gl * (dN_de * rN - 2.0 * dD_de * rD))
        gsb = (gy * (hrD2 * (e * e * D - A * (1.0 - 2.0 * emo)))
               + gl * (2.0 / sb + 2.0 * emo * rN
                       - 2.0 * (1.0 - 2.0 * emo) * rD))
        gs_k = (gy * (hrD2 * (emo * D - A * emo))
                + gl * ((1.0 - e) * (1.0 - e) * rN - 2.0 * emo * rD))
        gs_k1 = gy * (hrD2 * (-A * emo)) + gl * (e * e * rN - 2.0 * emo * rD)
        gw_bin = -rw * (ge * e + gsb * sb)
        gh_bin = gy * A * rD + gsb * rw
        gcw = -ge * rw   # flows to every width below the bin
        gch = gy         # flows to every height below the bin
        # d log(slope) / d slope in the tails, 1 / slope.
        gl_tail = gl * (1.0 / tl.where(below, s_first, s_last))

        gx = tl.where(inside, ge * rw, 0.0)
        gx = tl.where(below, gy * s_first, gx)
        gx = tl.where(above, gy * s_last, gx)
        tl.store(gx_ptr + xy, gx, mask=m)

        # Softmax chains: d/dlogit_k = R p_k (g_k - sum_j g_j p_j), with
        # g_k = g_bin at the bin, g_offset below it and 0 above it.
        dot_w = tl.where(inside, gw_bin * b_pw + gcw * b_cpw, 0.0)
        dot_h = tl.where(inside, gh_bin * b_ph + gch * b_cph, 0.0)
        g_w = tl.where(inside & at, gw_bin,
                       tl.where(inside & under, gcw, 0.0))
        g_h = tl.where(inside & at, gh_bin,
                       tl.where(inside & under, gch, 0.0))
        tl.store(gb, R_w * pw * (g_w - dot_w), mask=mk)
        tl.store(gb + K * F, R_h * ph * (g_h - dot_h), mask=mk)

        # Slope chains through softplus: d softplus(z) / dz = sigmoid(z).
        g_s = (tl.where(inside & at, gs_k, 0.0)
               + tl.where(inside & (kk == b + 1), gs_k1, 0.0))
        g_s += tl.where((kk == 0) & below, gy * xr + gl_tail, 0.0)
        g_last = (tl.where(inside & (b == K - 1), gs_k1, 0.0)
                  + tl.where(above, gy * (xr - W) + gl_tail, 0.0))
        if IDENTITY:
            tl.store(gb + (2 * K - 1) * F, g_s * sig, mask=mk & (kk >= 1))
        elif CIRCULAR:
            # Slope K is slope 0: its gradient joins row 2K's.
            g_s += tl.where(kk == 0, g_last, 0.0)
            tl.store(gb + 2 * K * F, g_s * sig, mask=mk)
        else:
            tl.store(gb + 2 * K * F, g_s * sig, mask=mk)
            tl.store(gp_ptr + goff + 3 * K * F, g_last * sig_last, mask=m)
        if SCALE:
            # d/d log(scale) of R_w, R_h is R_w, R_h: through every width
            # and height inside, through the upper tail's start and end
            # above.
            g_scale = tl.where(inside, R_w * dot_w + R_h * dot_h, 0.0)
            g_scale = tl.where(above, gy * (R_h - s_last * R_w), g_scale)
            tl.store(gp_ptr + goff + (NP - 1) * F, g_scale, mask=m)
        if CIRCULAR:
            # The shift moves the input: its gradient is the input's.
            tl.store(gp_ptr + goff + (NP - 1) * F, gx, mask=m)

    _KERNELS['forward'] = forward_kernel
    _KERNELS['backward'] = backward_kernel
    return _KERNELS


def _constants(device, dtype, min_bin_size, min_slope):
    """min_bin_size, min_slope, the offset and the pinned boundary slope
    as a tensor of the kernel's type, so float64 kernels get them
    unrounded. The pinned slope is ``softplus(0 + offset) + min_slope``
    in that type, as the transformer's plain path computes it from a zero
    parameter. Cached per device."""
    key = (device, dtype, min_bin_size, min_slope)
    if key not in _CONSTANTS:
        offset = spline_offset(min_slope)
        pinned = softplus(torch.zeros((), dtype=dtype) + offset) + min_slope
        _CONSTANTS[key] = torch.cat([
            torch.tensor([min_bin_size, min_slope, offset], dtype=dtype),
            pinned[None]]).to(device)
    return _CONSTANTS[key]


def _grid(B, F, block_b=BLOCK_B, block_f=BLOCK_F):
    return ((B + block_b - 1) // block_b, (F + block_f - 1) // block_f)


def _padded_bins(n_bins):
    """K2's bins axis: K rounded up to a power of two."""
    return 1 << max(n_bins - 1, 0).bit_length()


def _kind_constexprs(kind, n_bins):
    """The kernels' specialisation for ``kind``."""
    identity, scale, circular = KINDS[kind]
    return dict(NP=n_parameters(kind, n_bins), IDENTITY=int(identity),
                SCALE=int(scale), CIRCULAR=int(circular))


def _require_cuda(params, *tensors):
    """CUDA tensors, contiguous but for ``params``, whose rows may be
    strided (:func:`_rows`)."""
    for t in (params,) + tensors:
        if t.device.type != 'cuda' or not (
                _rows(t) if t is params else t.is_contiguous()):
            raise ValueError('The spline kernels take contiguous CUDA '
                             f'tensors, got one on {t.device}.')


def _rows(params):
    """Whether the kernels read ``params`` in place: features contiguous,
    rows at any stride."""
    return params.ndim == 2 and params.stride(1) == 1


def _count(direction, kind):
    name = f'{direction}_{kind}'
    setattr(LAUNCHES, direction, getattr(LAUNCHES, direction) + 1)
    setattr(LAUNCHES, name, getattr(LAUNCHES, name) + 1)


def launch_forward(x, params, x0, xf, y0, yf, n_bins, min_bin_size,
                   min_slope, kind='standard'):
    """Launch K1 on CUDA tensors; returns ``(y, log_dy_dx)``.

    Arguments as :func:`fused_spline`, which checks them; this launcher
    is the one place that counts K1's launches.
    """
    _require_cuda(params, x, x0, xf, y0, yf)
    y = torch.empty_like(x)
    dl = torch.empty_like(x)
    consts = _constants(x.device, x.dtype, min_bin_size, min_slope)
    _forward_launch(x, params, (x0, xf, y0, yf), consts, y, dl, n_bins, kind)
    _count('forward', kind)
    return y, dl


def _forward_launch(x, params, bounds, consts, y, dl, n_bins,
                    kind='standard'):
    """K1 into ``y`` and ``dl``; returns Triton's launch handle. Not
    counted: :func:`launch_forward` is K1's launcher."""
    B, F = x.shape
    with torch.cuda.device(x.device):
        return _kernels()['forward'][_grid(B, F)](
            x, params, *bounds, consts, y, dl, B, F, params.stride(0),
            K=n_bins, BLOCK_B=BLOCK_B, BLOCK_F=BLOCK_F, num_warps=NUM_WARPS,
            **_kind_constexprs(kind, n_bins))


def launch_backward(x, params, x0, xf, y0, yf, gy, gl, n_bins,
                    min_bin_size, min_slope, kind='standard'):
    """Launch K2 on CUDA tensors; returns ``(grad_x, grad_params)`` for
    the cotangents ``gy`` and ``gl`` of ``y`` and ``log_dy_dx``;
    ``grad_params`` is contiguous.

    Arguments as :func:`fused_spline`; this launcher is the one place that
    counts K2's launches.
    """
    _require_cuda(params, x, x0, xf, y0, yf, gy, gl)
    if gy.shape != x.shape or gl.shape != x.shape:
        raise ValueError(f'Cotangents must have shape {tuple(x.shape)}.')
    gx = torch.empty_like(x)
    gp = params.new_empty(params.shape)
    consts = _constants(x.device, x.dtype, min_bin_size, min_slope)
    _backward_launch(x, params, (x0, xf, y0, yf), consts, gy, gl, gx, gp,
                     n_bins, BACKWARD_LAYOUT, kind)
    _count('backward', kind)
    return gx, gp


def _backward_launch(x, params, bounds, consts, gy, gl, gx, gp, n_bins,
                     layout, kind='standard', kernel=None):
    """K2 (or ``kernel``, a build of its source) into ``gx`` and ``gp``
    with the tile ``layout`` (``BLOCK_B``, ``BLOCK_F``, ``num_warps``);
    returns Triton's launch handle. Not counted: :func:`launch_backward`
    is K2's launcher."""
    B, F = x.shape
    grid = _grid(B, F, layout['BLOCK_B'], layout['BLOCK_F'])
    kernel = _kernels()['backward'] if kernel is None else kernel
    with torch.cuda.device(x.device):
        return kernel[grid](
            x, params, *bounds, consts, gy, gl, gx, gp, B, F,
            params.stride(0), K=n_bins, KP=_padded_bins(n_bins), **layout,
            **_kind_constexprs(kind, n_bins))


class _FusedSpline(torch.autograd.Function):
    """K1 forward, K2 backward; the four bounds get no gradient.

    In the ``forward`` + ``setup_context`` form, so it composes with
    ``torch.func``. Under ``vmap`` (an ensemble of flows, one member per
    slice of the mapped axis) the members' rows are folded into one
    batch: K1 and K2 work row by row with per-feature bounds, so one
    launch serves every member, and the backward runs on the folded rows
    too (:class:`_SplineBackward`).
    """

    @staticmethod
    def forward(x, params, x0, xf, y0, yf, n_bins, min_bin_size, min_slope,
                kind='standard'):
        return launch_forward(x, params, x0, xf, y0, yf, n_bins,
                              min_bin_size, min_slope, kind)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, params, x0, xf, y0, yf, *config = inputs
        ctx.save_for_backward(x, params, x0, xf, y0, yf)
        ctx.config = tuple(config)

    @staticmethod
    def backward(ctx, gy, gl):
        gx, gp = _SplineBackward.apply(*ctx.saved_tensors, gy, gl,
                                       *ctx.config)
        return (gx, gp) + (None,) * (4 + len(ctx.config))

    @staticmethod
    def vmap(info, in_dims, x, params, x0, xf, y0, yf, *config):
        _shared_bounds(in_dims[2:6])
        n = info.batch_size
        x, params = (fold_members(t, d, n)
                     for t, d in zip((x, params), in_dims))
        _check_offsets(params)
        y, dl = _FusedSpline.apply(x, params, x0, xf, y0, yf, *config)
        return (unfold_members(y, n), unfold_members(dl, n)), (0, 0)


class _SplineBackward(torch.autograd.Function):
    """K2: ``(grad_x, grad_params)`` for the cotangents ``gy``, ``gl``.

    A Function of its own so that, under ``vmap``, K2 too runs once on
    the folded rows. It has no derivative: differentiating the spline
    twice raises.
    """

    @staticmethod
    def forward(x, params, x0, xf, y0, yf, gy, gl, n_bins, min_bin_size,
                min_slope, kind='standard'):
        return launch_backward(x, params, x0, xf, y0, yf, gy.contiguous(),
                               gl.contiguous(), n_bins, min_bin_size,
                               min_slope, kind)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ggx, ggp):
        raise RuntimeError('The fused spline (K1/K2) has no second '
                           'derivative.')

    @staticmethod
    def vmap(info, in_dims, x, params, x0, xf, y0, yf, gy, gl, *config):
        _shared_bounds(in_dims[2:6])
        n = info.batch_size
        x, params, gy, gl = (
            fold_members(t, d, n) for t, d in zip((x, params, gy, gl),
                                           in_dims[:2] + in_dims[6:8]))
        _check_offsets(params)
        gx, gp = _SplineBackward.apply(x, params, x0, xf, y0, yf, gy, gl,
                                       *config)
        return (unfold_members(gx, n), unfold_members(gp, n)), (0, 0)


def _shared_bounds(bound_dims):
    if any(d is not None for d in bound_dims):
        raise ValueError('Under vmap the spline bounds x0, xf, y0, yf must '
                         'be shared by every member (a buffer), not '
                         'mapped.')


def _check_offsets(params):
    B, P = params.shape
    if max(B * P, (B - 1) * params.stride(0) + P) >= 2 ** 31:
        raise ValueError('params is too large for the kernels\' 32-bit '
                         'offsets.')


def _check(x, params, bounds, n_bins, kind='standard'):
    if kind not in KINDS:
        raise ValueError(f'kind must be one of {tuple(KINDS)}, got '
                         f'{kind!r}.')
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'fused_spline takes float32 or float64, not '
                        f'{x.dtype}.')
    if x.ndim != 2 or x.numel() == 0:
        raise ValueError(f'x must be a non-empty (batch, n_features) '
                         f'tensor, got shape {tuple(x.shape)}.')
    B, F = x.shape
    P = n_parameters(kind, n_bins) * F
    if tuple(params.shape) != (B, P):
        raise ValueError(
            f'params must have shape {(B, P)} for n_bins={n_bins} and '
            f'kind={kind!r}, got {tuple(params.shape)}.')
    _check_offsets(params)
    for name, t in (('params', params),) + tuple(bounds.items()):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f'{name} must match x in dtype and device '
                            f'({x.dtype}, {x.device}), got {t.dtype}, '
                            f'{t.device}.')
    for name, t in bounds.items():
        if tuple(t.shape) != (F,):
            raise ValueError(f'{name} must have shape ({F},), got '
                             f'{tuple(t.shape)}.')
    for name, t in (('x', x),) + tuple(bounds.items()):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous.')
    if not _rows(params):
        raise ValueError('params must be contiguous along its features '
                         '(its rows may be strided).')


def fused_spline(x, params, x0, xf, y0, yf, n_bins: int,
                 min_bin_size: float = 1e-4, min_slope: float = 1e-4,
                 kind: str = 'standard'):
    """Fused rational-quadratic spline with linear tails (K1, K2).

    Differentiable with respect to ``x`` and ``params``. On a CUDA tensor it
    launches the Triton kernels (K1 forward, K2 backward); on a CPU tensor
    it runs :func:`fused_spline_reference`. Any other device raises.
    Both compose with ``torch.func`` (``grad``, ``vmap``); under ``vmap``
    the kernels run once on the members' rows folded into one batch.

    Parameters
    ----------
    x : torch.Tensor, shape (batch, n_features)
    params : torch.Tensor, shape (batch, P * n_features)
        Raw conditioner outputs, feature-contiguous per parameter (index
        ``p * n_features + f``): K width logits, K height logits, the
        kind's free slope pre-activations, then its domain scale's log or
        its shift (P per feature: :func:`n_parameters`). The rows may be
        strided (a slice of a wider tensor's columns): the kernels read
        them in place.
    x0, xf, y0, yf : torch.Tensor, shape (n_features,)
        Per-feature domain bounds.
    n_bins : int
        Number of bins K.
    min_bin_size, min_slope : float
        Floors applied after normalization.
    kind : str
        The spline configuration, a key of :data:`KINDS`: ``standard``,
        ``identity_upper``, ``circular`` or ``circular_identity``. A
        circular kind needs ``y0 == x0`` and ``yf == xf``.

    Returns
    -------
    y, log_dy_dx : torch.Tensor, shape (batch, n_features)
    """
    _check(x, params, dict(x0=x0, xf=xf, y0=y0, yf=yf), n_bins, kind)
    if x.device.type == 'cpu':
        return fused_spline_reference(x, params, x0, xf, y0, yf, n_bins,
                                      min_bin_size, min_slope, kind)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_spline runs on cuda or cpu tensors, not '
                         f'{x.device}.')
    return _FusedSpline.apply(x, params, x0, xf, y0, yf, n_bins,
                              float(min_bin_size), float(min_slope), kind)
