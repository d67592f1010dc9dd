"""The benchmark's runner: one cell of ``BENCHMARK.json``, one run.

A cell names a configuration and a traffic mix; everything the runner needs
is found by those names (``configs/``, ``traffic/``, ``reference/``,
``counts/``, ``limits/``, ``end_to_end/``, ``metrics/``), so a new cell,
mix, configuration or metric is new files and entries, not edits.

A run: make the frames and the weights from the seed, build the program's
map through its own entry point and hand it the weights, drive the
program's entry (``Trainer.fit`` or ``TFEPMapBase.run_evaluation``) through
its first steps (set-up), then measure for ``seconds``; with ``trace`` the
window is instead a fixed number of steps under ``torch.profiler``. After
the window the peak memory is read, the program's state is freed and the
plain reference checks what the timed path produced.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tfep_bench import checks, tracing
from tfep_bench import weights as draws

BENCH = Path(__file__).resolve().parent
#: Top-level modules the process must not hold once the window has closed.
BANNED = ('jax', 'jaxlib', 'flax', 'tfep_tpu')


def load(path: Path):
    """Import a file of the benchmark by its path."""
    name = 'tfep_bench_' + '_'.join(path.relative_to(BENCH).with_suffix('')
                                    .parts).replace('.', '_')
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _applies(metric, cell):
    return cell in metric.get('workloads', [cell])


class Cell:
    """One entry of ``workloads`` and the files its names point to.
    ``cfg`` and ``traffic`` update the configuration's and the mix's
    values (the tests' small sizes)."""

    def __init__(self, name, bench=None, cfg=None, traffic=None,
                 root=BENCH.parent):
        bench = bench or json.loads((root / 'BENCHMARK.json').read_text())
        entries = [w for w in bench['workloads'] if w['name'] == name]
        if not entries:
            raise KeyError(f'No workload {name!r} in BENCHMARK.json.')
        entry = entries[0]
        self.name, self.chips = name, int(entry['chips'])
        c, t = entry['config'], entry['traffic']
        self.cfg = json.loads((BENCH / 'configs' / f'{c}.json').read_text())
        self.cfg.update(cfg or {})
        self.traffic = json.loads(
            (BENCH / 'traffic' / f'{t}.json').read_text())
        self.traffic.update(traffic or {})
        self.adapter = load(BENCH / 'configs' / f'{c}.py')
        self.reference = load(BENCH / 'reference' / f'{c}.py')
        self.counts = load(BENCH / 'counts' / f'{c}.py')
        self.limits = json.loads((BENCH / 'limits' / f'{name}.json')
                                 .read_text())['limits']
        self.end_to_end = [m for m in bench['end_to_end']
                           if _applies(m, name)]
        self.per_layer = [m for m in bench['per_layer'] if _applies(m, name)]


# =============================================================================
# Around the program
# =============================================================================

class Probe:
    """Host spans around the calls into the program's map: the batch's
    copy to the device and the forward (``training_step_fn``; in an
    evaluation ``eval_batch``), with the backward's span opened after a
    training forward (the optimizer's pre-step hook closes it)."""

    def __init__(self, tmap, spans, training):
        to_device, step_fn = tmap.batch_to_device, tmap.training_step_fn
        name = 'training_step_fn' if training else 'eval_batch'

        def batch_to_device(batch):
            with spans('batch_to_device'):
                return to_device(batch)

        def training_step_fn(flow, batch):
            with spans(name):
                out = step_fn(flow, batch)
            if training:
                spans.open('backward')
            return out

        tmap.batch_to_device = batch_to_device
        tmap.training_step_fn = training_step_fn


def batch_order(shuffle_seed, n_frames, batch, n_steps):
    """The sample indices of the first ``n_steps`` steps, worked out from
    the shuffle seed as the trainer's sampler draws them: per epoch a
    permutation from ``SeedSequence([shuffle_seed, epoch])``."""
    out, epoch = [], 0
    while len(out) < n_steps:
        entropy = int(np.random.SeedSequence([shuffle_seed, epoch])
                      .generate_state(1, np.uint64)[0]) % (2 ** 63)
        order = np.random.default_rng(entropy).permutation(n_frames)
        out += [order[i:i + batch] for i in range(0, n_frames, batch)]
        epoch += 1
    return out[:n_steps]


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _mark(device):
    if device.type == 'cuda':
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def _ms_between(a, b):
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


class Profiler:
    """``torch.profiler`` over the traced window (the device's activity
    only), with the window span."""

    def __init__(self, device, spans):
        self.device, self.spans, self.prof, self.trace = (device, spans,
                                                          None, None)

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        activity = (ProfilerActivity.CUDA if self.device.type == 'cuda'
                    else ProfilerActivity.CPU)
        self.prof = profile(activities=[activity])
        self.prof.__enter__()
        self.spans.on = True
        self.spans.open(tracing.WINDOW)

    def stop(self):
        _sync(self.device)
        self.spans.close(tracing.WINDOW)
        self.spans.on = False
        self.prof.__exit__(None, None, None)
        self.trace = tracing.compact(tracing.device_events(self.prof),
                                     self.spans.records)
        self.prof = None


def _host_delta(after, before):
    return {k: [v[0] - before.get(k, [0.0, 0])[0],
                v[1] - before.get(k, [0.0, 0])[1]] for k, v in after.items()}


def _host_snapshot(trainer):
    return {k: list(v) for k, v in trainer.host_seconds.items()}


def host_copy(tensors):
    """A copy of each tensor on the host."""
    return {k: v.detach().to('cpu', copy=True) for k, v in tensors.items()}


class _Window:
    """The step clock of a training run, driven by the optimizer's
    post-step hook."""

    def __init__(self, trainer, optimizer, names, device, traffic, seconds,
                 profiler, spans):
        self.trainer, self.device, self.seconds = trainer, device, seconds
        self.n_check = int(traffic['check_steps'])
        self.n_warm = max(int(traffic['warmup_steps']), self.n_check)
        self.n_trace = int(traffic['trace_steps'])
        self.profiler, self.spans = profiler, spans
        self.names = names
        self.n, self.marks, self.t0 = 0, [], None
        self.first_grad = self.after = None
        self.host = {}
        optimizer.register_step_pre_hook(self.pre)
        optimizer.register_step_post_hook(self.post)

    def pre(self, optimizer, args, kwargs):
        self.spans.close('backward')
        self.spans.open('optimizer.step')
        if self.n == 0:
            self.first_grad = host_copy({
                name: torch.zeros_like(p) if p.grad is None else p.grad
                for name, p in zip(self.names,
                                   optimizer.param_groups[0]['params'])})
        return None

    def post(self, optimizer, args, kwargs):
        self.spans.close('optimizer.step')
        self.n += 1
        params = optimizer.param_groups[0]['params']
        if self.n == self.n_check:
            self.after = host_copy(dict(zip(self.names, params)))
        if self.n == self.n_warm:
            if self.profiler is None:
                _sync(self.device)
            self.t0 = time.perf_counter()
            self.host['start'] = _host_snapshot(self.trainer)
            self.marks.append(_mark(self.device))
            if self.profiler is not None:
                self.profiler.start()
        elif self.n > self.n_warm:
            self.marks.append(_mark(self.device))
            done = (self.n - self.n_warm >= self.n_trace
                    if self.profiler is not None
                    else time.perf_counter() - self.t0 >= self.seconds)
            if done:
                self.host['end'] = _host_snapshot(self.trainer)
                if self.profiler is not None:
                    self.profiler.stop()
                self.trainer.max_steps = self.trainer.global_step + 1
        return None


# =============================================================================
# The two entries
# =============================================================================

def _run_dir(traffic):
    """A directory of this run under ``TMPDIR`` for what the mix asks the
    program to write (``logger``: the work values' log;
    ``checkpoint_every_n_steps``: the trainer's checkpoints), or ``None``
    when it asks for neither."""
    if not (traffic.get('logger') or traffic.get('checkpoint_every_n_steps')):
        return None
    return Path(tempfile.mkdtemp(prefix='tfep_bench_'))


def _build(cell, seed, device, run_dir):
    """Frames and weights from the seed, the program's map set up with
    those weights; returns ``(map, frames on the host, weights on the
    host)``."""
    cfg, traffic = cell.cfg, cell.traffic
    frames = cell.adapter.frames(cfg, int(traffic['frames']), seed, device)
    spec = cell.reference.weight_spec(cell.reference.structure(cfg))
    weights = draws.draw(spec, seed, device,
                         dtype=getattr(torch, cfg['dtype']))
    host_frames = frames.cpu().numpy()
    del frames
    logger_dir = (str(run_dir / 'tfep_logs') if traffic.get('logger')
                  else None)
    tmap = cell.adapter.build_map(cfg, traffic, host_frames, device,
                                  logger_dir=logger_dir)
    tmap.setup()
    state = {cell.adapter.port_name(k): v for k, v in weights.items()}
    missing, unexpected = tmap.flow.load_state_dict(state, strict=False)
    named = dict(tmap.flow.named_parameters())
    left = [k for k in missing if k in named and named[k].numel()]
    if left or unexpected:
        raise RuntimeError(f'Weights do not match the program\'s leaves: '
                           f'missing {left}, unexpected {unexpected}.')
    return tmap, host_frames, host_copy(weights)


def run_fit(cell, seed, seconds, trace, device, t_start, run_dir,
            fault=None):
    """A training run through ``Trainer.fit``, shuffled with the
    prefetch thread; returns the run's record, the program's first steps
    and what the reference needs."""
    from tfep_tpu_torch.app import Trainer
    from tfep_tpu_torch.app.trainer import default_optimizer

    traffic, faults = cell.traffic, fault or {}
    spans = tracing.Spans()
    tmap, frames, weights = _build(cell, seed, device, run_dir)
    Probe(tmap, spans, training=True)
    if 'map' in faults:
        faults['map'](tmap)
    names = [k for k, p in tmap.flow.named_parameters() if p.requires_grad]
    profiler = Profiler(device, spans) if trace else None
    holder = {}

    def optimizer(params):
        opt = default_optimizer(params)
        holder['window'] = _Window(trainer, opt, names, device, traffic,
                                   seconds, profiler, spans)
        if 'optimizer' in faults:
            faults['optimizer'](opt)
        return opt

    shuffle_seed = draws.sub_seed(seed, 'shuffle')
    every = traffic.get('checkpoint_every_n_steps')
    trainer = Trainer(save_dir=str(run_dir / 'checkpoints') if every else None,
                      max_steps=10 ** 9, optimizer=optimizer,
                      checkpoint_every_n_steps=int(every or 1),
                      shuffle=True, shuffle_seed=shuffle_seed, prefetch=True)
    trainer.fit(tmap)
    _sync(device)
    t_end = time.perf_counter()
    w = holder['window']
    n_steps = w.n - w.n_warm
    batch = int(tmap.batch_size)
    losses = trainer.loss_history
    record = dict(
        entry='fit', setup_s=w.t0 - t_start, window_s=t_end - w.t0,
        steps=n_steps, frames=n_steps * batch,
        failed=batch * sum(not math.isfinite(x) for x in losses[w.n_warm:]),
        intervals_ms=[_ms_between(a, b) for a, b in zip(w.marks,
                                                        w.marks[1:])],
        host=_host_delta(w.host.get('end', {}), w.host.get('start', {})),
        trace=None if profiler is None else profiler.trace)
    program = (losses[:w.n_check], w.first_grad, w.after)
    checked = dict(indices=batch_order(shuffle_seed, len(frames), batch,
                                       w.n_check),
                   frames=frames, weights=weights, names=names)
    return record, program, checked, (tmap, trainer)


def run_evaluate(cell, seed, seconds, trace, device, t_start, run_dir,
                 fault=None):
    """An evaluation run: ``run_evaluation`` passes over the frames."""
    traffic, faults = cell.traffic, fault or {}
    spans = tracing.Spans()
    tmap, frames, weights = _build(cell, seed, device, run_dir)
    Probe(tmap, spans, training=False)
    if 'map' in faults:
        faults['map'](tmap)
    batch = int(traffic['eval_batch'])
    for i in range(int(traffic['warmup_passes'])):
        tmap.run_evaluation(step_idx=i, batch_size=batch)
    _sync(device)
    profiler = Profiler(device, spans) if trace else None
    t0 = time.perf_counter()
    if profiler is not None:
        profiler.start()
    passes, ends = [], [t0]
    while True:
        with spans('run_evaluation'):
            passes.append(tmap.run_evaluation(step_idx=len(passes),
                                              batch_size=batch))
        ends.append(time.perf_counter())
        if profiler is not None:
            if len(passes) >= int(traffic['trace_passes']):
                profiler.stop()
                break
        elif time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    t_end = time.perf_counter()
    n = len(frames)
    failed = sum(int(np.sum(~np.isfinite(p['potential'] - p['log_det_J'])))
                 for p in passes)
    record = dict(entry='evaluate', setup_s=t0 - t_start,
                  window_s=t_end - t0, steps=len(passes) * -(-n // batch),
                  frames=len(passes) * n, failed=failed, intervals_ms=[],
                  pass_ms=[(b - a) * 1e3 for a, b in zip(ends, ends[1:])],
                  host={}, trace=None if profiler is None else profiler.trace)
    checked = dict(frames=frames, weights=weights)
    return record, passes, checked, (tmap,)


# =============================================================================
# The check, the metrics, the result
# =============================================================================

def _free(device):
    """Return what the program's freed state held to the card."""
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()


def check_fit(cell, program, checked, device):
    """The reference through the checked steps on the same rows, from the
    same weights; returns the gaps."""
    ref = cell.reference
    dtype = getattr(torch, cell.cfg['dtype'])
    frames = torch.as_tensor(checked['frames'], device=device, dtype=dtype)
    ctx = ref.context(cell.cfg, frames)
    n = int(cell.traffic['check_steps'])
    batches = [dict(positions=frames[torch.as_tensor(idx, device=device)],
                    indices=idx, step=step)
               for step, idx in enumerate(checked['indices'][:n])]
    initial = {k: v.to(device) for k, v in checked['weights'].items()}
    reference = ref.train_steps(ctx, initial, batches)
    to_ref = {cell.adapter.port_name(k): k for k in checked['weights']}
    losses, moment, after = program
    program = (losses, {to_ref[k]: v for k, v in moment.items()
                        if k in to_ref},
               {to_ref[k]: v for k, v in after.items() if k in to_ref})
    reference = (reference[0], host_copy(reference[1]),
                 host_copy(reference[2]))
    return checks.training_gaps(program, reference, checked['weights'])


def check_evaluate(cell, passes, checked, device):
    """The reference's answers for every frame, in the configuration's
    precision and in float64; returns the gaps."""
    ref = cell.reference
    answers = []
    for dtype in (getattr(torch, cell.cfg['dtype']), torch.float64):
        frames = torch.as_tensor(checked['frames'], device=device,
                                 dtype=dtype)
        weights = {k: v.to(device, dtype)
                   for k, v in checked['weights'].items()}
        answers.append(ref.evaluate(ref.context(cell.cfg, frames), weights,
                                    frames))
        del frames, weights
    return checks.evaluation_gaps(passes, *answers)


def metrics(cell, record, trace_on, card):
    """The cell's metrics of this run: the end-to-end ones untraced, the
    per-layer ones traced; a reader that finds nothing to read returns
    ``None`` and its metric is left out."""
    out = {}
    if not trace_on:
        for m in cell.end_to_end:
            value = load(BENCH / 'end_to_end' / f'{m["name"]}.py').read(
                record)
            if value is not None:
                out[m['name']] = dict(value=value, unit=m['unit'])
        return out
    ctx = dict(trace=record['trace'], record=record, counts=cell.counts,
               cfg=cell.cfg, traffic=cell.traffic, card=card)
    for m in cell.per_layer:
        value = load(BENCH / 'metrics' / f'{m["name"]}.py').read(ctx)
        if value is not None:
            out[m['name']] = dict(value=value, unit=m['unit'])
    return out


def banned_modules() -> list:
    tops = {name.split('.')[0] for name in list(sys.modules)}
    return sorted(tops & set(BANNED))


def run(cell, seed, seconds, trace, device, t_start, card=None,
        fault=None):
    """One run of ``cell``; returns the result's dict (the last line of
    the output), the compared numbers with their limits and the run's
    record. ``fault`` (the tests' broken runs) maps ``'map'`` and
    ``'optimizer'`` to functions that break the program's map or
    optimizer once they are built."""
    device = torch.device(device)
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if torch.get_float32_matmul_precision() != 'highest':
            raise RuntimeError('float32 products must not run in TF32.')
    entry = cell.traffic['entry']
    runner = dict(fit=run_fit, evaluate=run_evaluate)[entry]
    run_dir = _run_dir(cell.traffic)
    try:
        record, program, checked, state = runner(
            cell, seed, seconds, trace, device, t_start, run_dir, fault)
    finally:
        if run_dir is not None:
            shutil.rmtree(run_dir, ignore_errors=True)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    record['peak_bytes'] = peak
    del state
    _free(device)
    gaps = (check_fit if entry == 'fit' else check_evaluate)(
        cell, program, checked, device)
    correct, rows = checks.judge(gaps, cell.limits)
    card = card or {}
    result = dict(correct=bool(correct and record['failed'] == 0),
                  attempted=int(record['frames']),
                  failed=int(record['failed']),
                  metrics=metrics(cell, record, trace, card))
    result['device'] = dict(platform='gpu' if device.type == 'cuda'
                            else device.type,
                            kind=card.get('kind', device.type),
                            count=cell.chips, memory_peak_bytes=int(peak),
                            power_limit_w=card.get('power_limit_w'))
    if trace:
        t = record['trace']
        result['device'].update(busy_s=tracing.busy_us(t) / 1e6,
                                window_s=tracing.window_us(t) / 1e6)
        result['breakdown'] = tracing.breakdown(t)
    result['compared'] = {name: dict(value=value, limit=limit)
                          for name, value, limit in rows}
    return result, rows, record
