"""The program's spans beside the device's operations
(``tfep_bench/program_trace.py``): the attribution rule and the joined
trace on synthetic traces, and the shared clock on two traces recorded on
the H100 with ``card_spans.py fixtures`` (``fixtures/spans_train.json``, a
flagship training step at batch 2048; ``fixtures/spans_eval.json``, an
evaluation pass at batch 4096)."""

import json
from pathlib import Path

import card_spans
import pytest

from tfep_bench import program_trace, tracing
from tfep_bench.harness import BENCH, Cell, load

FIXTURES_DIR = Path(__file__).parent / 'fixtures'


def _fixture(name):
    fixture = json.loads((FIXTURES_DIR / f'{name}.json').read_text())
    names = fixture['trace'].pop('names')
    trace = fixture['trace']
    trace['kernels'] = [[names[i], *rest] for i, *rest in trace['kernels']]
    trace['launches'] = [[names[i], *rest] for i, *rest in trace['launches']]
    return fixture


FIXTURES = {'mixed_maf_helix32.train': _fixture('spans_train'),
            'mixed_maf_helix32.eval': _fixture('spans_eval')}
MAIN, AUTOGRAD = 7, 9


def span(name, start, end, thread=MAIN, parent=None, id=0, step=0,
         thread_name='MainThread'):
    return [name, float(start), float(end - start), thread, parent, step, id,
            thread_name]


def launch(name, start, dur, at, thread=MAIN):
    return [name, float(start), float(dur), float(at), 1.0, thread]


def test_attribution_puts_a_launch_under_its_threads_span():
    """A kernel launched on autograd's thread belongs to that thread's
    innermost open span; one launched there outside any span to the main
    thread's innermost open span; one on the main thread to its own."""
    trace = dict(
        window=[0.0, 100.0], spans=[], main_thread=MAIN,
        program_spans=[
            span('step', 0, 90, id=1),
            span('step.forward', 1, 30, parent=1, id=2),
            span('maf.transformer', 5, 20, parent=2, id=3),
            span('step.backward', 30, 80, parent=1, id=4),
            span('maf.transformer.backward', 35, 50, thread=AUTOGRAD, id=5,
                 thread_name='Dummy-1'),
            span('read', 0, 95, thread=11, id=6,
                 thread_name='tfep-batch-prefetch_0')],
        launches=[launch('forward_kernel', 10, 2, 6),
                  launch('x', 12, 2, 25),
                  launch('backward_kernel', 40, 3, 36, AUTOGRAD),
                  launch('y', 60, 3, 55, AUTOGRAD),
                  launch('z', 95, 1, 91),
                  launch('late', 100, 1, 85)],
        kernels=[])
    assert program_trace.attribute(trace) == [
        (('maf.transformer', 'step.forward', 'step'), 'forward_kernel',
         10.0, 2.0),
        (('step.forward', 'step'), 'x', 12.0, 2.0),
        (('maf.transformer.backward',), 'backward_kernel', 40.0, 3.0),
        (('step.backward', 'step'), 'y', 60.0, 3.0),
        ((), 'z', 95.0, 1.0)]
    split = card_spans.layers(trace, steps=1)
    assert split['device_ms_a_step'] == pytest.approx(
        {'zmatrix.': 0.0, 'maf.conditioner': 0.0, 'maf.transformer': 5e-3})
    assert split['launches_a_step'] == 5


def test_join_adds_the_launching_threads_spans():
    """The program's spans of the main and autograd threads join the
    spans that ``breakdown`` names idle time by; the prefetch thread's go
    only into ``program_spans``."""
    from tfep_tpu_torch.utils.tracing import Span
    program = [Span('step', 10_000, 80_000, MAIN, 1, 'MainThread', None, 0,
                    1),
               Span('maf.transformer.backward', 40_000, 50_000, AUTOGRAD, 2,
                    'Dummy-1', None, 0, 2),
               Span('read', 0, 95_000, 11, 3, 'tfep-batch-prefetch_0', None,
                    1, 3)]
    trace = tracing.compact([['k', 20.0, 5.0]],
                            [[tracing.WINDOW, 0.0, 100.0]])
    joined = program_trace.join(
        trace, program, [['k', 20.0, 5.0, 15.0, 1.0, MAIN]], MAIN)
    assert trace['spans'] == [] and 'program_spans' not in trace
    assert joined['spans'] == [['step', 10.0, 70.0],
                               ['maf.transformer.backward', 40.0, 10.0]]
    assert [s[0] for s in joined['program_spans']] == [
        'step', 'maf.transformer.backward', 'read']
    assert joined['program_spans'][2][3:] == [11, None, 1, 3,
                                              'tfep-batch-prefetch_0']
    # Idle from 0 to 20 us before any span, from 25 us inside 'step'.
    assert dict(tracing.breakdown(joined)['idle_gaps']) == pytest.approx(
        {'step': 75e-6, 'outside the spans': 20e-6})


def test_self_time_leaves_out_the_children():
    """The own time of ``ode.step``, in the forward (main thread) and the
    recompute (autograd's): overlapping children count once."""
    trace = dict(window=[0.0, 100.0], spans=[], kernels=[], launches=[],
                 main_thread=MAIN, program_spans=[
                     span('step', 0, 100, id=1),
                     span('ode.step', 10, 14, parent=1, id=2),
                     span('child', 11, 12, parent=2, id=3),
                     span('child', 11.5, 13, parent=2, id=4),
                     span('ode.step', 20, 26, thread=AUTOGRAD, id=5)])
    own = [program_trace.self_us(trace, s)
           for s in program_trace.program_spans(trace, 'ode.step')]
    assert own == pytest.approx([2.0, 6.0])


def test_a_trace_without_program_spans():
    """A trace of a program that records no spans: nothing to attribute."""
    trace = tracing.compact([['k', 20.0, 5.0]],
                            [[tracing.WINDOW, 0.0, 100.0]])
    assert program_trace.program_spans(trace) == []
    assert program_trace.attribute(trace) == []


@pytest.mark.parametrize('cell', sorted(FIXTURES))
def test_the_fixtures_share_the_profilers_clock(cell):
    """On the card's recorded step and pass, every operation of the window
    has its launch, and all but the copies of the aux of the step the
    window opened in (whose ``step`` span opened before the recorder) are
    put down to a program span; every K1 launch lies inside a
    ``maf.transformer`` span, every K2 launch inside a
    ``maf.transformer.backward`` span (on autograd's thread)."""
    trace = FIXTURES[cell]['trace']
    t0, t1 = trace['window']
    ops = program_trace.attribute(trace)
    assert len(ops) == sum(t0 <= s < t1 for _, s, _ in trace['kernels'])
    first = min(s[1] for s in program_trace.program_spans(trace))
    assert all(names or name.startswith('Memcpy DtoH') and start < first
               for names, name, start, _ in ops)
    where = {}
    for names, name, *_ in ops:
        if name in ('forward_kernel', 'backward_kernel'):
            where.setdefault(name, set()).add(names[0])
    assert where['forward_kernel'] == {'maf.transformer'}
    if cell.endswith('.train'):
        assert where['backward_kernel'] == {'maf.transformer.backward'}
    checks = card_spans.clock_checks(trace)
    assert checks['named_share'] > 0.99 and checks['unlaunched'] == 0


@pytest.mark.parametrize('cell', sorted(FIXTURES))
def test_the_accepted_readers_read_a_joined_trace(cell):
    """The program's keys and spans leave the benchmark's own readers
    working: each of the cell's per-layer metrics reads a number."""
    fixture = FIXTURES[cell]
    c = Cell(cell, traffic=fixture['traffic'])
    ctx = dict(trace=fixture['trace'], record=fixture['record'],
               counts=c.counts, cfg=c.cfg, traffic=c.traffic,
               card=dict(kind=fixture['kind']))
    for metric in c.per_layer:
        value = load(BENCH / 'metrics' / f'{metric["name"]}.py').read(ctx)
        assert value is not None and value >= 0.0, metric['name']
