"""The port's span recorder (``tfep_tpu_torch/utils/tracing.py``) and its
spans in the trainer, the evaluation, the Z-matrix, MAF and ODE layers, on
the CPU."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from tfep_tpu_torch.app import MixedMAFMap, Trainer
from tfep_tpu_torch.io.topology import Topology
from tfep_tpu_torch.io.traj import System
from tfep_tpu_torch.nn.ode import odeint
from tfep_tpu_torch.units import ureg
from tfep_tpu_torch.utils import tracing

N_ATOMS = 8
STEP_SPANS = {'step.forward', 'step.backward', 'step.optimizer'}
EVAL_SPANS = ['eval.batch', 'eval.read', 'eval.to_device', 'eval.forward',
              'eval.to_host']
LAYERS = ('zmatrix.to_internal', 'zmatrix.to_cartesian', 'maf.conditioner',
          'maf.transformer')


@pytest.fixture(autouse=True)
def recorder_off():
    yield
    if tracing.is_on():
        tracing.stop()


class Harmonic:
    energy_unit = ureg.kilocalorie_per_mole

    def __call__(self, x, cell=None):
        return 0.5 * torch.sum(x * x, dim=-1)


def helix_map(tmp_path=None, n_frames=24, batch_size=6, **kwargs):
    """A small ``MixedMAFMap`` on a noisy helical chain, on the CPU."""
    turns = np.arange(N_ATOMS) * 1.2
    helix = np.stack([1.5 * np.cos(turns), 1.5 * np.sin(turns),
                      0.3 * np.arange(N_ATOMS)], axis=1)
    rng = np.random.default_rng(0)
    frames = helix + 0.05 * rng.standard_normal((n_frames, N_ATOMS, 3))
    topology = Topology(names=[f'C{i}' for i in range(N_ATOMS)],
                        elements=['C'] * N_ATOMS,
                        bonds=[(i, i + 1) for i in range(N_ATOMS - 1)])
    return MixedMAFMap(
        potential_energy_func=Harmonic(), temperature=300 * ureg.kelvin,
        system=System(topology, frames), batch_size=batch_size,
        tfep_logger_dir_path=None if tmp_path is None
        else str(tmp_path / 'logs'),
        n_maf_layers=2, n_bins=4, device='cpu', dtype=torch.float64,
        **kwargs)


def by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_records_nothing_and_reads_no_clock(monkeypatch, tmp_path):
    class NoClock:
        @staticmethod
        def time_ns():
            raise AssertionError('the clock was read')

    with monkeypatch.context() as m:
        m.setattr(tracing, 'time', NoClock)
        assert tracing.span('a') is tracing.span('b', step=3)
        with tracing.span('a'):
            pass
        x = torch.ones(3, requires_grad=True)
        y = tracing.layer('maf.transformer', torch.sin, x)
        assert type(y.grad_fn).__name__ == 'SinBackward0'
        tracing.end_backward()

    tmap = helix_map(tmp_path)
    trainer = Trainer(save_dir=str(tmp_path / 'ck'), max_steps=3,
                      prefetch=True, shuffle_seed=0)
    trainer.fit(tmap)
    assert {name: calls for name, (_, calls)
            in trainer.host_seconds.items()} == {
        'read': 4, 'to_device': 3, 'step': 3, 'log': 3, 'checkpoint': 3}
    tracing.start()
    assert tracing.stop() == []


def test_nesting_parents_threads_and_steps():
    tracing.start()
    tracing.set_step(3)
    with tracing.span('outer'):
        with tracing.span('inner', step=7):
            pass
        totals = {}
        with tracing.timed(totals, 'timed'):
            pass
    worker = threading.Thread(target=lambda: tracing.span('other').__enter__(),
                              name='worker')
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    records = by_name(tracing.stop())
    outer, inner = records['outer'][0], records['inner'][0]
    timed, other = records['timed'][0], records['other'][0]
    assert outer.parent is None and outer.step == 3
    assert inner.parent == outer.id and inner.step == 7
    assert timed.parent == outer.id and timed.step == 3
    assert totals['timed'][1] == 1 and totals['timed'][0] == pytest.approx(
        (timed.end_ns - timed.start_ns) / 1e9)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    main = threading.main_thread()
    assert {outer.thread, inner.thread, timed.thread} == {main.ident}
    assert outer.native_thread == main.native_id
    assert outer.thread_name == main.name
    # A span left open on another thread is closed by stop().
    assert other.thread != main.ident and other.thread_name == 'worker'
    assert other.parent is None and other.end_ns >= other.start_ns


def test_fit_with_prefetch(tmp_path):
    tmap = helix_map()
    trainer = Trainer(save_dir=None, max_steps=3, prefetch=True,
                      shuffle_seed=0)
    tracing.start()
    trainer.fit(tmap)
    records = tracing.stop()
    spans = by_name(records)
    main = threading.main_thread().ident
    assert all(r.thread_name.startswith('tfep-batch-prefetch')
               and r.thread != main for r in spans['read'])
    assert sorted(r.step for r in spans['read'])[:3] == [0, 1, 2]
    for name in ['read_wait', 'to_device', 'step', 'log'] + sorted(
            STEP_SPANS):
        assert all(r.thread == main for r in spans[name]), name
    assert [r.step for r in spans['read_wait']] == [0, 1, 2]
    assert [r.step for r in spans['step']] == [0, 1, 2]
    assert [r.step for r in spans['log']] == [0, 1, 2]
    ids = {r.id: r for r in spans['step']}
    for name in STEP_SPANS:
        assert len(spans[name]) == 3
        for r in spans[name]:
            assert r.parent in ids and ids[r.parent].step == r.step
    assert set(trainer.host_seconds) == {'read', 'to_device', 'step', 'log'}


def test_run_evaluation_spans(tmp_path):
    tmap = helix_map(tmp_path, n_frames=20)
    tmap.setup()
    tracing.start()
    out = tmap.run_evaluation(step_idx=0, batch_size=6)
    spans = by_name(tracing.stop())
    assert len(out['potential']) == 20
    assert [r.step for r in spans['eval.batch']] == [0, 1, 2, 3]
    batches = {r.id: r for r in spans['eval.batch']}
    for name in EVAL_SPANS[1:]:
        assert [r.step for r in spans[name]] == [0, 1, 2, 3]
        assert all(batches[r.parent].step == r.step for r in spans[name])
    assert len(spans['eval.log']) == 1
    assert spans['eval.log'][0].start_ns >= spans['eval.batch'][-1].end_ns
    # No gradient, so no backward span.
    assert not [n for n in spans if n.endswith('.backward')]
    assert len(spans['maf.conditioner']) == 2 * 4


@pytest.mark.parametrize('checkpoint', [True, False])
def test_ode_step_again_in_the_backward(checkpoint):
    w = torch.tensor([0.3, -0.2], dtype=torch.float64, requires_grad=True)
    state0 = (torch.ones(4, 2, dtype=torch.float64),)
    tracing.start()
    state = odeint(lambda t, s: (torch.tanh(s[0] * w),), state0, 0.0, 1.0,
                   n_steps=3, solver='rk4', checkpoint=checkpoint)
    with tracing.span('backward'):
        state[0].sum().backward()
    spans = by_name(tracing.stop())
    backward = spans['backward'][0]
    inside = [r for r in spans['ode.step']
              if r.start_ns >= backward.start_ns]
    assert len(spans['ode.step']) == (6 if checkpoint else 3)
    assert len(inside) == (3 if checkpoint else 0)
    assert all(r.end_ns <= backward.end_ns for r in inside)


def _loss_and_grads(tmap, batch):
    flow = tmap.flow
    flow.zero_grad(set_to_none=True)
    loss, _ = tmap.training_step_fn(flow, tmap.batch_to_device(batch))
    loss.backward()
    tracing.end_backward()
    return loss.detach().clone(), {k: p.grad.clone() for k, p
                                   in flow.named_parameters()
                                   if p.grad is not None}


def _marker_nodes(tensor):
    seen, stack, found = set(), [tensor.grad_fn], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        found += 'Marker' in type(node).__name__
        stack.extend(n for n, _ in node.next_functions)
    return found


def test_backward_markers_are_bit_identical():
    tmap = helix_map()
    tmap.setup()
    torch.manual_seed(0)
    with torch.no_grad():
        for p in tmap.flow.parameters():
            p.add_(0.05 * torch.randn_like(p))
    batch = tmap.dataset.get_batch(np.arange(6))
    loss_off, grads_off = _loss_and_grads(tmap, batch)
    assert _marker_nodes(tmap.training_step_fn(
        tmap.flow, tmap.batch_to_device(batch))[0]) == 0

    tracing.start()
    with tracing.span('step.backward'):
        loss_on, grads_on = _loss_and_grads(tmap, batch)
    records = tracing.stop()
    assert torch.equal(loss_on, loss_off)
    assert grads_on.keys() == grads_off.keys() and grads_off
    for name, grad in grads_off.items():
        assert torch.equal(grads_on[name], grad), name

    spans = by_name(records)
    for name in LAYERS:
        assert len(spans[name]) == (1 if name.startswith('zmatrix') else 2)
    # The data take no gradient: no backward of the conversion to internal
    # coordinates; one of every other layer, in the backward's order.
    assert 'zmatrix.to_internal.backward' not in spans
    backward = sorted((r for r in records if r.name.endswith('.backward')
                       and r.name != 'step.backward'),
                      key=lambda r: r.start_ns)
    assert [r.name for r in backward] == [
        'zmatrix.to_cartesian.backward',
        'maf.transformer.backward', 'maf.conditioner.backward',
        'maf.transformer.backward', 'maf.conditioner.backward']
    for a, b in zip(backward, backward[1:]):
        assert a.end_ns <= b.start_ns
    outer = spans['step.backward'][0]
    assert all(outer.start_ns <= r.start_ns and r.end_ns <= outer.end_ns
               for r in backward)


def test_layer_under_torch_func():
    x = torch.linspace(0.0, 1.0, 5, dtype=torch.float64)
    tracing.start()
    grad = torch.func.grad(
        lambda v: tracing.layer('maf.transformer', torch.sin, v).sum())(x)
    spans = by_name(tracing.stop())
    assert torch.equal(grad, torch.cos(x))
    assert len(spans['maf.transformer']) == 1
    assert 'maf.transformer.backward' not in spans


def test_profile_dir_trace_holds_the_spans(tmp_path):
    tmap = helix_map()
    trainer = Trainer(save_dir=None, max_steps=4, prefetch=True,
                      shuffle_seed=0, profile_dir=str(tmp_path / 'prof'),
                      profile_steps=(1, 3))
    trainer.fit(tmap)
    assert not tracing.is_on()
    trace = json.loads((tmp_path / 'prof' / 'trace.json').read_text())
    spans = [e for e in trace['traceEvents'] if e.get('cat') == 'tfep_span']
    names = {e['name'] for e in spans}
    assert {'step', 'read', 'read_wait', 'to_device', 'log'} | STEP_SPANS \
        | set(LAYERS) <= names
    assert sorted(e['args']['step'] for e in spans
                  if e['name'] == 'step') == [1, 2]
    ops = [e for e in trace['traceEvents'] if e.get('cat') == 'cpu_op']
    assert all(e['ph'] == 'X' and e['pid'] == os.getpid() for e in spans)
    assert min(e['ts'] for e in ops) - 1e5 < min(e['ts'] for e in spans)
    assert max(e['ts'] for e in spans) < max(e['ts'] + e['dur']
                                             for e in ops) + 1e5
    main = threading.main_thread().native_id
    assert {e['tid'] for e in spans if e['name'] == 'step'} == {main}


def test_threads_record_concurrently():
    """More threads than cores open and close nested spans and timed
    blocks at once, with a short switch interval: no record is lost and
    each keeps its own thread's parent."""
    import sys
    n_threads, n_spans = 4 * (os.cpu_count() or 1) + 2, 50
    totals = [{} for _ in range(n_threads)]

    def work(i):
        for j in range(n_spans):
            with tracing.span('outer', step=i):
                with tracing.timed(totals[i], 'inner', step=j):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tracing.start()
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        records = tracing.stop()
    finally:
        sys.setswitchinterval(interval)
    spans = by_name(records)
    assert len(spans['outer']) == len(spans['inner']) == n_threads * n_spans
    outer = {r.id: r for r in spans['outer']}
    for r in spans['inner']:
        parent = outer[r.parent]
        assert parent.thread == r.thread
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    assert all(t['inner'][1] == n_spans for t in totals)
