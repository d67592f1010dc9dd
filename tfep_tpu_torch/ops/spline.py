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

Design. One program owns a ``(BLOCK_B, BLOCK_F)`` tile, one element per
thread, and walks the K bins in an unrolled ``tl.static_range`` loop, so
each parameter row is loaded coalesced along F. Unlike the TPU kernels,
which evaluate every bin in every lane and mask afterwards, a thread
selects its own bin's width, height, knots and slopes with a running
``tl.where`` and evaluates the map once (the clamp of ``e`` is kept). In K2
the TPU kernel's suffix sums over the cumulative offsets become "add this
element's offset gradient to every bin below its own", written while the
parameter gradients are streamed out, so no per-bin accumulator stays
live. There is no feature padding and no batch tiling constraint: ragged B
and F edges are masked. Triton compiles both kernels at their first launch
from this source, into ``TRITON_CACHE_DIR`` (default ``build/triton`` of
the checkout).

The wrapper :func:`fused_spline` launches the kernels for CUDA tensors and
runs :func:`fused_spline_reference`, the plain PyTorch version of the same
math, only for CPU tensors.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from tfep_tpu_torch.ops import LaunchCounter

__all__ = ['fused_spline', 'fused_spline_reference', 'LAUNCHES', 'softplus',
           'spline_offset', 'launch_forward', 'launch_backward',
           'forward_bytes', 'backward_bytes', 'forward_ops', 'backward_ops']


def forward_bytes(B: int, F: int, K: int, itemsize: int) -> int:
    """Least bytes K1 moves: x, params and 4 bound rows in; y, dl out."""
    return itemsize * (B * F + B * (3 * K + 1) * F + 4 * F + 2 * B * F)


def backward_bytes(B: int, F: int, K: int, itemsize: int) -> int:
    """Least bytes K2 moves: x, params, 4 bound rows, gy, gl in; gx,
    gparams out."""
    return itemsize * (3 * B * F + 2 * B * (3 * K + 1) * F + 4 * F + B * F)


# Operations per element, counted from the kernels below: each arithmetic
# operation, comparison, select and transcendental once; loads, stores and
# index arithmetic not at all.
def forward_ops(B: int, F: int, K: int) -> int:
    """Operations K1 does on a (B, F) input with K bins."""
    return B * F * (44 * K + 62)


def backward_ops(B: int, F: int, K: int) -> int:
    """Operations K2 does on a (B, F) input with K bins."""
    return B * F * (89 * K + 145)


LAUNCHES = LaunchCounter('forward', 'backward')

BLOCK_B = 4
BLOCK_F = 32
NUM_WARPS = 4

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
                           min_slope: float = 1e-4):
    """Plain PyTorch version of the kernels' function, element by element.

    Follows the kernel's math: softmax, softplus with offset, the per-bin
    rational-quadratic map under a mask with the clamp of the bin-relative
    position, and linear tails outside ``[x0, xf]``. Its autograd is the
    reference for K2. Arguments as :func:`fused_spline`.

    Returns
    -------
    y, log_dy_dx : torch.Tensor, shape (batch, n_features)
    """
    K = n_bins
    B, F = x.shape
    p = params.reshape(B, 3 * K + 1, F)
    R_w = (xf - x0) - K * min_bin_size
    R_h = (yf - y0) - K * min_bin_size
    widths = torch.softmax(p[:, :K], dim=1) * R_w + min_bin_size
    heights = torch.softmax(p[:, K:2 * K], dim=1) * R_h + min_bin_size
    slopes = softplus(p[:, 2 * K:] + spline_offset(min_slope)) + min_slope

    zero = torch.zeros_like(widths[:, :1])
    cw = torch.cat([zero, torch.cumsum(widths[:, :-1], dim=1)], dim=1)
    ch = torch.cat([zero, torch.cumsum(heights[:, :-1], dim=1)], dim=1)
    xr = (x - x0)[:, None]
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
    W = xf - x0
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
    global tl, _softplus_tl
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
    def forward_kernel(x_ptr, p_ptr, x0_ptr, xf_ptr, y0_ptr, yf_ptr, c_ptr,
                       y_ptr, dl_ptr, B, F, K: tl.constexpr,
                       BLOCK_B: tl.constexpr, BLOCK_F: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
        cols = tl.program_id(1) * BLOCK_F + tl.arange(0, BLOCK_F)
        cmask = cols < F
        m = (rows < B)[:, None] & cmask[None, :]
        xy = rows[:, None] * F + cols[None, :]
        pb = p_ptr + rows[:, None] * ((3 * K + 1) * F) + cols[None, :]
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
            s_hi = _softplus_tl(tl.load(pb + (2 * K + k + 1) * F, mask=m,
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
    def backward_kernel(x_ptr, p_ptr, x0_ptr, xf_ptr, y0_ptr, yf_ptr, c_ptr,
                        gy_ptr, gl_ptr, gx_ptr, gp_ptr, B, F,
                        K: tl.constexpr, BLOCK_B: tl.constexpr,
                        BLOCK_F: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
        cols = tl.program_id(1) * BLOCK_F + tl.arange(0, BLOCK_F)
        cmask = cols < F
        m = (rows < B)[:, None] & cmask[None, :]
        xy = rows[:, None] * F + cols[None, :]
        poff = rows[:, None] * ((3 * K + 1) * F) + cols[None, :]
        pb = p_ptr + poff
        gb = gp_ptr + poff
        min_bin = tl.load(c_ptr)
        min_slope = tl.load(c_ptr + 1)
        offset = tl.load(c_ptr + 2)

        x = tl.load(x_ptr + xy, mask=m, other=0.0)
        gy = tl.load(gy_ptr + xy, mask=m, other=0.0)
        gl = tl.load(gl_ptr + xy, mask=m, other=0.0)
        x0 = tl.load(x0_ptr + cols, mask=cmask, other=0.0)[None, :]
        xf = tl.load(xf_ptr + cols, mask=cmask, other=1.0)[None, :]
        y0 = tl.load(y0_ptr + cols, mask=cmask, other=0.0)[None, :]
        yf = tl.load(yf_ptr + cols, mask=cmask, other=1.0)[None, :]
        R_w = (xf - x0) - K * min_bin
        R_h = (yf - y0) - K * min_bin
        xr = x - x0
        W = xf - x0
        below = xr < 0.0
        above = xr >= W
        inside = (xr >= 0.0) & (xr < W)

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

        # Walk the bins as K1 does, also keeping the bin's index, its
        # softmax probabilities and the probability mass below it.
        s_lo = _softplus_tl(tl.load(pb + 2 * K * F, mask=m, other=0.0)
                            + offset) + min_slope
        s_first = s_lo
        cw = tl.zeros_like(x)
        ch = tl.zeros_like(x)
        cpw = tl.zeros_like(x)
        cph = tl.zeros_like(x)
        b_k = tl.zeros((BLOCK_B, BLOCK_F), dtype=tl.int32)
        for k in tl.static_range(K):
            pw = tl.exp(tl.load(pb + k * F, mask=m, other=0.0) - w_max) / w_sum
            ph = (tl.exp(tl.load(pb + (K + k) * F, mask=m, other=0.0) - h_max)
                  / h_sum)
            w_k = pw * R_w + min_bin
            h_k = ph * R_h + min_bin
            s_hi = _softplus_tl(tl.load(pb + (2 * K + k + 1) * F, mask=m,
                                        other=0.0) + offset) + min_slope
            if k == 0:
                b_w = w_k
                b_h = h_k
                b_cw = cw
                b_ch = ch
                b_sk = s_lo
                b_sk1 = s_hi
                b_pw = pw
                b_ph = ph
                b_cpw = cpw
                b_cph = cph
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
                b_pw = tl.where(in_bin, pw, b_pw)
                b_ph = tl.where(in_bin, ph, b_ph)
                b_cpw = tl.where(in_bin, cpw, b_cpw)
                b_cph = tl.where(in_bin, cph, b_cph)
                b_k = tl.where(in_bin, k, b_k)
            cw = cw + w_k
            ch = ch + h_k
            cpw = cpw + pw
            cph = cph + ph
            s_lo = s_hi
        s_last = s_lo

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
               + gl * (2.0 * b_w / b_h + 2.0 * emo * rN
                       - 2.0 * (1.0 - 2.0 * emo) * rD))
        gs_k = (gy * (hrD2 * (emo * D - A * emo))
                + gl * ((1.0 - e) * (1.0 - e) * rN - 2.0 * emo * rD))
        gs_k1 = gy * (hrD2 * (-A * emo)) + gl * (e * e * rN - 2.0 * emo * rD)
        gw_bin = -rw * (ge * e + gsb * sb)
        gh_bin = gy * A * rD + gsb * rw
        gcw = -ge * rw   # flows to every width below the bin
        gch = gy         # flows to every height below the bin

        gx = tl.where(inside, ge * rw, 0.0)
        gx = tl.where(below, gy * s_first, gx)
        gx = tl.where(above, gy * s_last, gx)
        tl.store(gx_ptr + xy, gx, mask=m)

        # Softmax chains: d/dlogit_k = R p_k (g_k - sum_j g_j p_j), with
        # g_k = g_bin at the bin, g_offset below it and 0 above it.
        dot_w = tl.where(inside, gw_bin * b_pw + gcw * b_cpw, 0.0)
        dot_h = tl.where(inside, gh_bin * b_ph + gch * b_cph, 0.0)
        for k in tl.static_range(K):
            pw = tl.exp(tl.load(pb + k * F, mask=m, other=0.0) - w_max) / w_sum
            ph = (tl.exp(tl.load(pb + (K + k) * F, mask=m, other=0.0) - h_max)
                  / h_sum)
            g_w = tl.where(inside & (b_k == k), gw_bin,
                           tl.where(inside & (b_k > k), gcw, 0.0))
            g_h = tl.where(inside & (b_k == k), gh_bin,
                           tl.where(inside & (b_k > k), gch, 0.0))
            tl.store(gb + k * F, R_w * pw * (g_w - dot_w), mask=m)
            tl.store(gb + (K + k) * F, R_h * ph * (g_h - dot_h), mask=m)

        # Slope chains through softplus: d softplus(z) / dz = sigmoid(z).
        for j in tl.static_range(K + 1):
            z = tl.load(pb + (2 * K + j) * F, mask=m, other=0.0) + offset
            g_s = (tl.where(inside & (b_k == j), gs_k, 0.0)
                   + tl.where(inside & (b_k + 1 == j), gs_k1, 0.0))
            if j == 0:
                g_s += tl.where(below, gy * xr + gl / s_first, 0.0)
            if j == K:
                g_s += tl.where(above, gy * (xr - W) + gl / s_last, 0.0)
            tl.store(gb + (2 * K + j) * F, g_s / (1.0 + tl.exp(-z)), mask=m)

    _KERNELS['forward'] = forward_kernel
    _KERNELS['backward'] = backward_kernel
    return _KERNELS


def _constants(device, dtype, min_bin_size, min_slope):
    """min_bin_size, min_slope and the offset as a tensor of the kernel's
    type, so float64 kernels get them unrounded. Cached per device."""
    key = (device, dtype, min_bin_size, min_slope)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.tensor(
            [min_bin_size, min_slope, spline_offset(min_slope)],
            dtype=dtype, device=device)
    return _CONSTANTS[key]


def _grid(B, F):
    return ((B + BLOCK_B - 1) // BLOCK_B, (F + BLOCK_F - 1) // BLOCK_F)


def _require_cuda(*tensors):
    for t in tensors:
        if t.device.type != 'cuda' or not t.is_contiguous():
            raise ValueError('The spline kernels take contiguous CUDA '
                             f'tensors, got one on {t.device}.')


def launch_forward(x, params, x0, xf, y0, yf, n_bins, min_bin_size,
                   min_slope):
    """Launch K1 on CUDA tensors; returns ``(y, log_dy_dx)``.

    Arguments as :func:`fused_spline`, which checks them; this launcher
    is the one place that counts K1's launches.
    """
    _require_cuda(x, params, x0, xf, y0, yf)
    kernels = _kernels()
    B, F = x.shape
    y = torch.empty_like(x)
    dl = torch.empty_like(x)
    consts = _constants(x.device, x.dtype, min_bin_size, min_slope)
    with torch.cuda.device(x.device):
        kernels['forward'][_grid(B, F)](
            x, params, x0, xf, y0, yf, consts, y, dl, B, F, K=n_bins,
            BLOCK_B=BLOCK_B, BLOCK_F=BLOCK_F, num_warps=NUM_WARPS)
    LAUNCHES.forward += 1
    return y, dl


def launch_backward(x, params, x0, xf, y0, yf, gy, gl, n_bins,
                    min_bin_size, min_slope):
    """Launch K2 on CUDA tensors; returns ``(grad_x, grad_params)`` for
    the cotangents ``gy`` and ``gl`` of ``y`` and ``log_dy_dx``.

    Arguments as :func:`fused_spline`; this launcher is the one place that
    counts K2's launches.
    """
    _require_cuda(x, params, x0, xf, y0, yf, gy, gl)
    if gy.shape != x.shape or gl.shape != x.shape:
        raise ValueError(f'Cotangents must have shape {tuple(x.shape)}.')
    kernels = _kernels()
    B, F = x.shape
    gx = torch.empty_like(x)
    gp = torch.empty_like(params)
    consts = _constants(x.device, x.dtype, min_bin_size, min_slope)
    with torch.cuda.device(x.device):
        kernels['backward'][_grid(B, F)](
            x, params, x0, xf, y0, yf, consts, gy, gl, gx, gp, B, F,
            K=n_bins, BLOCK_B=BLOCK_B, BLOCK_F=BLOCK_F, num_warps=NUM_WARPS)
    LAUNCHES.backward += 1
    return gx, gp


class _FusedSpline(torch.autograd.Function):
    """K1 forward, K2 backward; the four bounds get no gradient."""

    @staticmethod
    def forward(ctx, x, params, x0, xf, y0, yf, n_bins, min_bin_size,
                min_slope):
        ctx.save_for_backward(x, params, x0, xf, y0, yf)
        ctx.config = (n_bins, min_bin_size, min_slope)
        return launch_forward(x, params, x0, xf, y0, yf, n_bins,
                              min_bin_size, min_slope)

    @staticmethod
    def backward(ctx, gy, gl):
        x, params, x0, xf, y0, yf = ctx.saved_tensors
        gx, gp = launch_backward(x, params, x0, xf, y0, yf,
                                 gy.contiguous(), gl.contiguous(),
                                 *ctx.config)
        return gx, gp, None, None, None, None, None, None, None


def _check(x, params, bounds, n_bins):
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f'fused_spline takes float32 or float64, not '
                        f'{x.dtype}.')
    if x.ndim != 2 or x.numel() == 0:
        raise ValueError(f'x must be a non-empty (batch, n_features) '
                         f'tensor, got shape {tuple(x.shape)}.')
    B, F = x.shape
    if tuple(params.shape) != (B, (3 * n_bins + 1) * F):
        raise ValueError(
            f'params must have shape {(B, (3 * n_bins + 1) * F)} for '
            f'n_bins={n_bins}, got {tuple(params.shape)}.')
    if params.numel() >= 2 ** 31:
        raise ValueError('params is too large for the kernels\' 32-bit '
                         'offsets.')
    for name, t in (('params', params),) + tuple(bounds.items()):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f'{name} must match x in dtype and device '
                            f'({x.dtype}, {x.device}), got {t.dtype}, '
                            f'{t.device}.')
    for name, t in bounds.items():
        if tuple(t.shape) != (F,):
            raise ValueError(f'{name} must have shape ({F},), got '
                             f'{tuple(t.shape)}.')
    for name, t in (('x', x), ('params', params)) + tuple(bounds.items()):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous.')


def fused_spline(x, params, x0, xf, y0, yf, n_bins: int,
                 min_bin_size: float = 1e-4, min_slope: float = 1e-4):
    """Fused rational-quadratic spline with linear tails (K1, K2).

    Differentiable with respect to ``x`` and ``params``. On a CUDA tensor it
    launches the Triton kernels (K1 forward, K2 backward); on a CPU tensor
    it runs :func:`fused_spline_reference`. Any other device raises.

    Parameters
    ----------
    x : torch.Tensor, shape (batch, n_features)
    params : torch.Tensor, shape (batch, (3K+1) * n_features)
        Raw conditioner outputs, feature-contiguous per parameter (index
        ``p * n_features + f``): K width logits, K height logits, K+1
        slope pre-activations.
    x0, xf, y0, yf : torch.Tensor, shape (n_features,)
        Per-feature domain bounds.
    n_bins : int
        Number of bins K.
    min_bin_size, min_slope : float
        Floors applied after normalization.

    Returns
    -------
    y, log_dy_dx : torch.Tensor, shape (batch, n_features)
    """
    _check(x, params, dict(x0=x0, xf=xf, y0=y0, yf=yf), n_bins)
    if x.device.type == 'cpu':
        return fused_spline_reference(x, params, x0, xf, y0, yf, n_bins,
                                      min_bin_size, min_slope)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_spline runs on cuda or cpu tensors, not '
                         f'{x.device}.')
    return _FusedSpline.apply(x, params, x0, xf, y0, yf, n_bins,
                              float(min_bin_size), float(min_slope))
