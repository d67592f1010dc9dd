"""The frozen counts of the benchmark equal the program's today."""

import itertools

import pytest

from tfep_bench.harness import BENCH, load
from tfep_tpu_torch.ops import egnn, spline

MIXED = load(BENCH / 'counts' / 'mixed_maf_helix32.py')
CNF = load(BENCH / 'counts' / 'cnf_egnn32.py')


@pytest.mark.parametrize('B,F,K', [(32768, 30, 8), (65536, 30, 8),
                                   (4096, 96, 8), (7, 3, 5)])
def test_spline_counts_are_the_programs(B, F, K):
    for item in (4, 8):
        assert MIXED.forward_bytes(B, F, K, item) == spline.forward_bytes(
            B, F, K, item)
        assert MIXED.backward_bytes(B, F, K, item) == spline.backward_bytes(
            B, F, K, item)
    assert MIXED.forward_ops(B, F, K) == spline.forward_ops(B, F, K)
    assert MIXED.backward_ops(B, F, K) == spline.backward_ops(B, F, K)


@pytest.mark.parametrize('B,n,F,D', list(itertools.product(
    [1024, 256, 3], [32, 7], [64, 24], [64, 10])))
def test_egnn_counts_are_the_programs(B, n, F, D):
    assert CNF.n_weight_elements(F, D) == egnn.n_weight_elements(F, D)
    for k in ('k3', 'k4', 'k5'):
        assert getattr(CNF, f'{k}_ops')(B, n, F, D) == getattr(
            egnn, f'{k}_ops')(B, n, F, D)
        assert getattr(CNF, f'{k}_bytes')(B, n, F, D, 4) == getattr(
            egnn, f'{k}_bytes')(B, n, F, D, 4)


def test_step_flops_of_the_flagship():
    """MADE's dense FLOPs are 54.2 MFLOP a row for a training step."""
    import json
    cfg = json.loads((BENCH / 'configs' / 'mixed_maf_helix32.json')
                     .read_text())
    assert 3 * MIXED.made_forward_flops(cfg, 1) == 54224100
    assert MIXED.spline_shape(cfg) == (30, 8)
    assert MIXED.step_flops(cfg, 2, True) == 2 * MIXED.step_flops(cfg, 1,
                                                                    True)
