"""Operations and bytes of the CNF map's work, from its shapes.

The EGNN kernels' counts are frozen copies of ``k3_bytes``, ``k4_bytes``,
``k5_bytes``, ``k3_ops``, ``k4_ops``, ``k5_ops`` and ``n_weight_elements``
of ``tfep_tpu_torch/ops/egnn.py`` as the kernels were when the benchmark
was written (each byte read or written once; a multiply-add of a product
as two, every other arithmetic operation once), so that a later change to
the program cannot move the yardstick.
"""

from __future__ import annotations


def n_weight_elements(F, D):
    return 2 * D + F * D + 2 * F * F + 5 * F + 1


def k3_bytes(B, n, F, D, itemsize):
    return itemsize * (3 * B * n * F + 2 * B * n * n
                       + n_weight_elements(F, D))


def k4_bytes(B, n, F, D, itemsize):
    return itemsize * (6 * B * n * F + 4 * B * n * n
                       + n_weight_elements(F, D))


def k5_bytes(B, n, F, D, itemsize):
    return itemsize * (10 * B * n * F + 6 * B * n * n
                       + 2 * n_weight_elements(F, D))


def k3_ops(B, n, F, D):
    return B * n * n * (2 * (F * D + 2 * F * F) + 12 * D + 28 * F + 10)


def k4_ops(B, n, F, D):
    return B * n * n * (4 * (F * D + 2 * F * F) + 23 * D + 55 * F + 17)


def k5_ops(B, n, F, D):
    per_pair = (k4_ops(1, 1, F, D) + 8 * (F * D + 2 * F * F) + 82 * D
                + 102 * F + 22)
    return B * n * n * per_pair + B * n_weight_elements(F, D)


COUNTS = {'K3': (k3_ops, k3_bytes), 'K4': (k4_ops, k4_bytes),
          'K5': (k5_ops, k5_bytes)}


def _shape(cfg):
    return (int(cfg['n_atoms']), int(cfg['node_feat_dim']),
            int(cfg['distance_feat_dim']))


def egnn_bound_s(kernel, B, cfg, peaks, itemsize=4):
    """The least time of one launch of ``kernel`` (``'K3'``, ``'K4'`` or
    ``'K5'``, with its reduction of the weight gradients) on ``B`` frames."""
    ops, nbytes = COUNTS[kernel]
    n, F, D = _shape(cfg)
    return max(ops(B, n, F, D) / peaks['fp32_flops'],
               nbytes(B, n, F, D, itemsize) / peaks['hbm_bytes_per_s'])


def field_evaluations(cfg):
    """Evaluations of the field per pass: four per rk4 step."""
    return 4 * int(cfg['ode_steps'])


def step_flops(cfg, B, training):
    """FLOPs of one step on ``B`` frames, without the checkpoints'
    recomputation: per field evaluation and layer, K4 (the pair block with
    the probe's tangent) and, when training, K5, plus the node-level dense
    products (the first message layer's two node terms and the feature
    update, for the primal and the tangent), three times over with the
    backward."""
    n, F, D = _shape(cfg)
    launches = field_evaluations(cfg) * int(cfg['n_egnn_layers'])
    node = launches * B * n * 2 * (2 * (2 * F * F) + 2 * (3 * F * F))
    if training:
        return launches * (k4_ops(B, n, F, D) + k5_ops(B, n, F, D)) \
            + 3 * node
    return launches * k4_ops(B, n, F, D) + node
