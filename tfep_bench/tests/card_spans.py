#!/usr/bin/env python3
"""The program's spans on the card: the fixtures of the span tests, and the
checks of the shared clock and of the recorder's cost.

    python3 tfep_bench/tests/card_spans.py fixtures [DIR]
    python3 tfep_bench/tests/card_spans.py check <cell> [--seed N]
        [--runs on,off,off,on] [--out DIR]

From the root of a checkout, on a machine with a CUDA card. Both run the
benchmark's harness with a traced window (``--trace 1``) whose profiler
also turns the program's span recorder on (``tfep_tpu_torch.utils.tracing``)
and keeps each device operation's launch (:mod:`tfep_bench.program_trace`).
``fixtures`` records a traced flagship training step and a traced
evaluation pass at small batches into ``DIR/spans_train.json`` and
``DIR/spans_eval.json`` (``tfep_bench/tests/fixtures`` by default).
``check`` runs a cell's traced window with the recorder on and off in
turns, the profiler on in both, and prints, for each run, the window's
step (or pass) times and, with the recorder on: where the spline and EGNN
kernels were launched, the share of the window's device time put down to a
program span, the device time by layer, the launches a step, the host
spans the data layer and the ODE solver take, and the idle time by span.
Each run's numbers also go to ``DIR/card_spans_<cell>.json``
(``build/card_spans`` by default).
"""

import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

FIXTURES = {
    'mixed_maf_helix32.train': dict(fixture='spans_train', frames=8192,
                                    batch=2048, warmup_steps=4,
                                    check_steps=3, trace_steps=1),
    'mixed_maf_helix32.eval': dict(fixture='spans_eval', frames=8192,
                                   eval_batch=4096, warmup_passes=1,
                                   trace_passes=1),
}
SEED = 3_000_000_021


def _card():
    import torch
    limit = subprocess.run(
        ['nvidia-smi', '--query-gpu=power.limit',
         '--format=csv,noheader,nounits'], capture_output=True,
        text=True).stdout.split()
    return dict(kind=torch.cuda.get_device_name(0),
                power_limit_w=float(limit[0]) if limit else None)


def _run(name, seed, recorder=True, traffic=None):
    """One traced run of ``name`` through the harness; with ``recorder``,
    its profiler also turns the program's recorder on over the window, and
    the trace gains the program's spans and the launches."""
    from tfep_bench import harness, program_trace
    from tfep_tpu_torch.utils import tracing as spans

    class Profiler(harness.Profiler):
        def start(self):
            super().start()
            spans.start()

        def stop(self):
            prof = self.prof
            super().stop()
            self.trace = program_trace.join(
                self.trace, spans.stop(), program_trace.launch_events(prof),
                threading.main_thread().ident)

    saved = harness.Profiler
    if recorder:
        harness.Profiler = Profiler
    try:
        cell = harness.Cell(name, traffic=traffic)
        return cell, harness.run(cell, seed, 30.0, True, 'cuda',
                                 time.perf_counter(), _card())
    finally:
        harness.Profiler = saved


def _indexed(rows, names):
    index = {n: i for i, n in enumerate(names)}
    return [[index[r[0]], *(round(x, 3) if isinstance(x, float) else x
                            for x in r[1:])] for r in rows]


def fixtures(out_dir):
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, traffic in FIXTURES.items():
        traffic = dict(traffic)
        fixture = traffic.pop('fixture')
        cell, (result, _, record) = _run(name, SEED, traffic=traffic)
        trace = record.pop('trace')
        names = sorted({k[0] for k in trace['kernels']}
                       | {k[0] for k in trace['launches']})
        trace = dict(trace, names=names,
                     kernels=_indexed(trace['kernels'], names),
                     launches=_indexed(trace['launches'], names))
        what = ('training step' if cell.traffic['entry'] == 'fit'
                else 'evaluation pass')
        batch = traffic.get('batch', traffic.get('eval_batch'))
        out = dict(trace=trace, record=record, traffic=cell.traffic,
                   kind=result['device']['kind'],
                   about=f'One traced {what} of {name} at batch {batch} '
                         f'over {traffic["frames"]} frames on an '
                         f'{result["device"]["kind"]} '
                         f'({result["device"]["power_limit_w"]} W), with '
                         f'the program\'s spans and the launches; kernels '
                         f'and launches name by index into names.')
        path = out_dir / f'{fixture}.json'
        path.write_text(json.dumps(out, separators=(',', ':')))
        print(json.dumps(dict(fixture=str(path),
                              correct=result['correct'],
                              threads=_threads(trace))), flush=True)


def _threads(trace):
    """Launches and program spans by thread: which threads launched."""
    out = {}
    for k in trace.get('launches', ()):
        out.setdefault(k[-1], dict(launches=0, spans=0, names=set()))
        out[k[-1]]['launches'] += 1
    for s in trace.get('program_spans', ()):
        out.setdefault(s[3], dict(launches=0, spans=0, names=set()))
        out[s[3]]['spans'] += 1
        out[s[3]]['names'].add(s[7])
    return {str(t): dict(v, names=sorted(v['names']),
                         main=t == trace.get('main_thread'))
            for t, v in out.items()}


def clock_checks(trace):
    """Where the spline and EGNN kernels were launched, and the share of
    the window's device time put down to a program span."""
    from tfep_bench import program_trace, tracing
    ops = program_trace.attribute(trace)
    t0, t1 = trace['window']
    device = sum(d for _, s, d in trace['kernels'] if t0 <= s < t1)
    named = sum(d for names, _, _, d in ops if names)
    by_kernel = {}
    for names, name, _, _ in ops:
        low = name.lower()
        kernel = ('K1' if low == 'forward_kernel' else
                  'K2' if low == 'backward_kernel' else
                  'K4' if 'egnn_fwd_kernel' in low else
                  'K5' if 'egnn_kernel' in low or 'reduce_partials' in low
                  else None)
        if kernel is None:
            continue
        where = names[0] if names else 'no span'
        if kernel in ('K4', 'K5') and names and 'ode.step' in names:
            where = 'ode.step' + ('' if names[0] == 'ode.step'
                                  else ' > ' + names[0])
        counts = by_kernel.setdefault(kernel, {})
        counts[where] = counts.get(where, 0) + 1
    by_span = {}
    for names, _, _, d in ops:
        key = names[0] if names else 'no span'
        by_span[key] = by_span.get(key, 0.0) + d / 1e3
    # Idle time (s) by the innermost program span, and its thread, open on
    # the main or autograd's thread when the device fell idle.
    idle, last = {}, t0
    launching = [p for p in program_trace.program_spans(trace)
                 if not p[7].startswith('tfep-')]
    for a, b in tracing.busy_intervals(trace) + [[t1, t1]]:
        if a > last:
            open_ = [p for p in launching if p[1] <= last < p[1] + p[2]]
            inner = max(open_, key=lambda p: p[1]) if open_ else None
            thread = (None if inner is None else 'main'
                      if inner[3] == trace['main_thread'] else inner[7])
            key = ('outside the spans' if inner is None else
                   f'{inner[0]} ({thread})')
            idle[key] = idle.get(key, 0.0) + (a - last) / 1e6
        last = max(last, b)
    ode = {}
    for p in program_trace.program_spans(trace, 'ode.step'):
        key = 'main' if p[3] == trace['main_thread'] else p[7]
        ode.setdefault(key, []).append(program_trace.self_us(trace, p) / 1e3)
    return dict(device_ms=device / 1e3, named_share=named / device
                if device else None, kernels=by_kernel,
                device_ms_by_innermost_span=dict(sorted(
                    by_span.items(), key=lambda kv: -kv[1])[:20]),
                idle_s_by_span_and_thread=dict(sorted(
                    idle.items(), key=lambda kv: -kv[1])[:12]),
                ode_step_self_ms={k: dict(n=len(v), mean=sum(v) / len(v))
                                  for k, v in ode.items()},
                unlaunched=sum(1 for _, s, _ in trace['kernels']
                               if t0 <= s < t1) - len(ops))


def layers(trace, steps):
    """Per step (an evaluation batch): the device ms launched inside the
    Z-matrix's, the MAF conditioner's and the MAF transformer's spans,
    forward and backward; the operations launched inside the main
    thread's ``step`` spans; the ms of the data layer's host spans."""
    from tfep_bench import program_trace
    ops = program_trace.attribute(trace)
    device = {prefix: sum(d for names, _, _, d in ops
                          if any(n.startswith(prefix) for n in names))
              / steps / 1e3
              for prefix in ('zmatrix.', 'maf.conditioner', 'maf.transformer')}
    main_steps = [s for s in program_trace.program_spans(trace, 'step')
                  if s[3] == trace['main_thread']]
    launches = sum(any(s[1] <= k[3] < s[1] + s[2] for s in main_steps)
                   for k in trace['launches'])
    host = {name: sum(s[2] for s in program_trace.program_spans(trace, name))
            / steps / 1e3 for name in ('read_wait', 'eval.read',
                                       'eval.to_host')}
    return dict(device_ms_a_step=device, host_ms_a_step=host,
                launches_a_step=launches / len(main_steps)
                if main_steps else None)


def check(name, seed, runs, out_dir):
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f'card_spans_{name}.json'
    rows = []
    for i, mode in enumerate(runs):
        _, (result, _, record) = _run(name, seed + i, recorder=mode == 'on')
        times = record['intervals_ms'] or record['pass_ms']
        row = dict(run=i, recorder=mode, seed=seed + i,
                   correct=result['correct'], times_ms=times,
                   median_ms=statistics.median(times),
                   window_s=record['window_s'], device=result['device'],
                   metrics=result['metrics'],
                   idle_gaps=result['breakdown']['idle_gaps'])
        if mode == 'on':
            trace = record['trace']
            row.update(clock_checks(trace), threads=_threads(trace),
                       layers=layers(trace, record['steps']))
        rows.append(row)
        print(json.dumps(row), flush=True)
        out_path.write_text(json.dumps(rows, indent=1))
    for mode in ('on', 'off'):
        medians = [r['median_ms'] for r in rows if r['recorder'] == mode]
        print(f'{name} recorder {mode}: medians {medians} ms', flush=True)


def main(argv):
    from tfep_bench import run
    run._caches()
    if argv[:1] == ['fixtures']:
        return fixtures(Path(argv[1]) if len(argv) > 1
                        else Path(__file__).parent / 'fixtures')
    if argv[:1] == ['check'] and len(argv) >= 2:
        seed, runs = SEED, ['on', 'off', 'off', 'on']
        out_dir = ROOT / 'build' / 'card_spans'
        rest = argv[2:]
        while rest:
            key, value, rest = rest[0], rest[1], rest[2:]
            if key == '--seed':
                seed = int(value)
            elif key == '--runs':
                runs = value.split(',')
            elif key == '--out':
                out_dir = Path(value)
            else:
                sys.exit(f'unknown option {key}')
        return check(argv[1], seed, runs, out_dir)
    sys.exit(__doc__)


if __name__ == '__main__':
    main(sys.argv[1:])
