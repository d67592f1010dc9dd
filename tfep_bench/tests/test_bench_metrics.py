"""Every reader works on a small recorded trace: a traced window of the
flagship's training on the H100 (one step at batch 2048), with the
window's record; readers of another cell's kernels find nothing there
and return nothing, and no share of a roofline or peak passes 100%."""

import json
from pathlib import Path

import pytest

from tfep_bench import tracing
from tfep_bench.harness import BENCH, Cell, load

FIXTURE = json.loads((Path(__file__).parent / 'fixtures' /
                      'trace_small.json').read_text())
_NAMES = FIXTURE['trace'].pop('names')
FIXTURE['trace']['kernels'] = [[_NAMES[i], s, d] for i, s, d in
                               FIXTURE['trace']['kernels']]
BENCHMARK = json.loads((BENCH.parent / 'BENCHMARK.json').read_text())


def context(name, **traffic):
    cell = Cell(name, traffic=dict(FIXTURE['traffic'], **traffic))
    return dict(trace=FIXTURE['trace'], record=FIXTURE['record'],
                counts=cell.counts, cfg=cell.cfg, traffic=cell.traffic,
                card=dict(kind=FIXTURE['kind']))


@pytest.mark.parametrize('metric', [m['name'] for m in
                                    BENCHMARK['per_layer']])
def test_reader(metric):
    reader = load(BENCH / 'metrics' / f'{metric}.py')
    if metric.endswith('.eval'):
        ctx = context('mixed_maf_helix32.eval',
                      eval_batch=FIXTURE['traffic']['batch'])
    else:
        ctx = context('mixed_maf_helix32.train')
    value = reader.read(ctx)
    if metric == 'egnn_roofline.train':
        assert value is None          # no EGNN kernel in the fixture
        return
    assert value is not None and value == value and value >= 0.0
    if 'roofline' in metric or 'mfu' in metric or 'share' in metric:
        assert value <= 100.0


def test_busy_is_a_union():
    trace = dict(window=[0.0, 10.0], spans=[['run_evaluation', 0.0, 10.0]],
                 kernels=[['a', 1.0, 2.0], ['b', 2.0, 2.0], ['c', 8.0, 5.0]])
    assert tracing.busy_intervals(trace) == [[1.0, 4.0], [8.0, 10.0]]
    assert tracing.busy_us(trace) == 5.0
    gaps = tracing.breakdown(trace)
    assert gaps['idle_gaps'] == [['run_evaluation', 5e-06]]
    assert gaps['device_ops'][0] == ['c', 5e-06]


def test_breakdown_of_the_fixture():
    b = tracing.breakdown(FIXTURE['trace'])
    assert 1 <= len(b['device_ops']) <= 10 and len(b['idle_gaps']) <= 10
    busy = tracing.busy_us(FIXTURE['trace'])
    assert 0 < busy <= tracing.window_us(FIXTURE['trace'])
    assert sum(s for _, s in b['idle_gaps']) == pytest.approx(
        (tracing.window_us(FIXTURE['trace']) - busy) / 1e6)


def test_kinds():
    assert tracing.kind('forward_kernel') == 'spline'
    assert tracing.kind('void egnn_kernel<float>(Args<float>)') == 'egnn'
    assert tracing.kind('sm90_xmma_gemm_f32f32_f32f32_f32_tn_n') == 'matmul'
    assert tracing.kind('void at::native::multi_tensor_apply_kernel') == \
        'optimizer'
    assert tracing.kind('Memcpy HtoD (Pinned -> Device)') == 'copy'
    assert tracing.kind('void at::native::elementwise_kernel<128, 2>') == \
        'elementwise'
