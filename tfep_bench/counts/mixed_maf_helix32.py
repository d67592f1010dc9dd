"""Operations and bytes of the flagship map's work, from its shapes.

The spline kernels' counts are frozen copies of ``forward_bytes``,
``backward_bytes``, ``forward_ops`` and ``backward_ops`` of
``tfep_tpu_torch/ops/spline.py`` as the kernels were when the benchmark
was written (each byte read or written once, each operation of the
kernel's arithmetic once), so that a later change to the program cannot
move the yardstick. The conditioner's FLOPs are its dense products, a
multiply-add as two.
"""

from __future__ import annotations

from tfep_bench.harness import BENCH, load


def forward_bytes(B, F, K, itemsize):
    """K1: x, params and 4 bound rows in; y, dl out."""
    return itemsize * (B * F + B * (3 * K + 1) * F + 4 * F + 2 * B * F)


def backward_bytes(B, F, K, itemsize):
    """K2: x, params, 4 bound rows, gy, gl in; gx, gparams out."""
    return itemsize * (3 * B * F + 2 * B * (3 * K + 1) * F + 4 * F + B * F)


def forward_ops(B, F, K):
    return B * F * (44 * K + 62)


def backward_ops(B, F, K):
    return B * F * (81 * K + 159)


def _structure(cfg):
    ref = load(BENCH / 'reference' / 'mixed_maf_helix32.py')
    return ref.structure(cfg)


def spline_shape(cfg):
    """``(F, K)`` of K1 and K2: the angles' spline, the one in the standard
    configuration the kernels take."""
    spec = _structure(cfg)
    return len(spec.layout.angles), spec.K


def launch_bound_s(kernel, B, cfg, peaks, itemsize=4):
    """The least time of one launch of ``kernel`` (``'K1'`` or ``'K2'``)
    on ``B`` rows: the larger of operations over the float32 peak and
    bytes over the memory bandwidth."""
    F, K = spline_shape(cfg)
    if kernel == 'K1':
        ops, nbytes = forward_ops(B, F, K), forward_bytes(B, F, K, itemsize)
    else:
        ops, nbytes = backward_ops(B, F, K), backward_bytes(B, F, K,
                                                            itemsize)
    return max(ops / peaks['fp32_flops'], nbytes / peaks['hbm_bytes_per_s'])


def made_forward_flops(cfg, B):
    """Dense FLOPs of every MADE's forward on ``B`` rows."""
    spec = _structure(cfg)
    total = 0
    for layer in spec.layers:
        d = layer['degrees']
        total += sum(len(a) * len(b) for a, b in zip(d, d[1:]))
    return 2 * B * total


def step_flops(cfg, B, training):
    """FLOPs of one step on ``B`` rows: the conditioner's forward (three
    times it with the backward) and the spline kernels' operations, one K1
    (and one K2 when training) per MAF layer."""
    F, K = spline_shape(cfg)
    n = int(cfg['n_maf_layers'])
    if training:
        return 3 * made_forward_flops(cfg, B) + n * (
            forward_ops(B, F, K) + backward_ops(B, F, K))
    return made_forward_flops(cfg, B) + n * forward_ops(B, F, K)
