"""Small sizes of the benchmark's cells for the CPU tests."""

import time

from tfep_bench import harness

MIXED_CFG = dict(n_atoms=8, n_maf_layers=2, n_bins=4)
CNF_CFG = dict(n_atoms=6, node_feat_dim=8, distance_feat_dim=8,
               time_feat_dim=4, n_egnn_layers=2, ode_steps=2)
TRAFFIC = {
    'mixed_maf_helix32.train': dict(frames=256, batch=64, warmup_steps=3,
                                    trace_steps=2),
    'mixed_maf_helix32.eval': dict(frames=256, eval_batch=64,
                                   trace_passes=1),
    'cnf_egnn32.train': dict(frames=32, batch=8, trace_steps=1),
}
SEED = 2 ** 31 + 2 ** 20 + 7


def cell(name, dtype='float64', **traffic):
    cfg = dict(MIXED_CFG if name.startswith('mixed') else CNF_CFG,
               dtype=dtype)
    return harness.Cell(name, cfg=cfg,
                        traffic=dict(TRAFFIC[name], **traffic))


def run(c, seconds=0.2, trace=False, fault=None, seed=SEED):
    return harness.run(c, seed, seconds, trace, 'cpu', time.perf_counter(),
                       dict(kind='cpu'), fault=fault)
