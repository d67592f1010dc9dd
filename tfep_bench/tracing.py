"""From a ``torch.profiler`` trace to the benchmark's compact trace.

The compact trace is plain data, so that the per-layer readers can be
tested on a recorded one: ``{"window": [start_us, end_us], "kernels":
[[name, start_us, duration_us], ...], "spans": [[name, start_us,
duration_us], ...]}``. ``kernels`` holds every operation that ran on the
device (kernels, copies, fills), from the profiler's device activity
alone: recording the host's operators too would slow the host, which sets
the pace of these steps, by half. ``spans`` are the benchmark's own host
spans around its calls into the program, timed on the host's wall clock,
the clock the profiler gives the device's times in.
"""

from __future__ import annotations

import contextlib
import time

WINDOW = 'bench.window'


def kind(name: str) -> str:
    """The kind of a device operation, by its name: ``spline`` (K1, K2),
    ``egnn`` (K3, K4, K5 and the reduction of K5's partial sums),
    ``matmul`` (cuBLAS), ``optimizer``, ``copy`` or ``elementwise``
    (PyTorch's own elementwise and reduction kernels)."""
    name = name.lower()
    if name in ('forward_kernel', 'backward_kernel'):
        return 'spline'
    if 'egnn_' in name or 'reduce_partials' in name:
        return 'egnn'
    if any(s in name for s in ('gemm', 'xmma', 'cutlass', 'sm90_', 'nvjet')):
        return 'matmul'
    if 'multi_tensor' in name or 'adam' in name:
        return 'optimizer'
    if 'memcpy' in name or 'memset' in name:
        return 'copy'
    return 'elementwise'


class Spans:
    """Host spans around the program's calls, recorded while a trace is
    taken (``on``) as ``[name, start_us, duration_us]`` on the wall
    clock."""

    def __init__(self):
        self.on = False
        self.records = []
        self._open = {}

    @contextlib.contextmanager
    def __call__(self, name):
        if not self.on:
            yield
            return
        start = time.time_ns()
        try:
            yield
        finally:
            self._add(name, start)

    def _add(self, name, start):
        self.records.append([name, start / 1e3,
                             (time.time_ns() - start) / 1e3])

    def open(self, name):
        """Open a span that another call closes (:meth:`close`)."""
        if self.on and name not in self._open:
            self._open[name] = time.time_ns()

    def close(self, name):
        start = self._open.pop(name, None)
        if start is not None:
            self._add(name, start)


def device_events(prof):
    """``[name, start_us, duration_us]`` of every device operation of a
    finished profile."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            out.append([e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3])
    return out


def compact(kernels, spans) -> dict:
    """The compact trace of the device operations and the host spans (one
    :data:`WINDOW` span among them marks the window)."""
    window = [s for s in spans if s[0] == WINDOW]
    if len(window) != 1:
        raise RuntimeError('The trace has no window span.')
    _, start, dur = window[0]
    return dict(window=[start, start + dur],
                kernels=sorted(kernels, key=lambda k: k[1]),
                spans=sorted((s for s in spans if s[0] != WINDOW),
                             key=lambda s: s[1]))


def busy_intervals(trace):
    """The union of the device operations' intervals inside the window,
    as sorted disjoint ``[start, end]`` pairs (us)."""
    t0, t1 = trace['window']
    merged = []
    for _, start, dur in trace['kernels']:
        a, b = max(start, t0), min(start + dur, t1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_us(trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace))


def window_us(trace) -> float:
    return trace['window'][1] - trace['window'][0]


def kind_us(trace, kinds) -> float:
    """Device time of the operations of the given kinds in the window."""
    t0, t1 = trace['window']
    return sum(dur for name, start, dur in trace['kernels']
               if kind(name) in kinds and start >= t0 and start < t1)


def launches(trace, names) -> list:
    """``[(name, duration_us)]`` of the window's launches of ``names``
    (a predicate on the lower-case name)."""
    t0, t1 = trace['window']
    return [(n, d) for n, s, d in trace['kernels']
            if names(n.lower()) and t0 <= s < t1]


def breakdown(trace, top=10) -> dict:
    """The device operations that took most time, and the idle time by the
    innermost host span open when the device fell idle, each the ``top``
    largest, in seconds."""
    t0, t1 = trace['window']
    by_name = {}
    for name, start, dur in trace['kernels']:
        if t0 <= start < t1:
            by_name[name] = by_name.get(name, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, last = [], t0
    for a, b in busy_intervals(trace):
        if a > last:
            gaps.append((last, a))
        last = b
    if t1 > last:
        gaps.append((last, t1))
    spans = trace['spans']
    idle = {}
    for a, b in gaps:
        inner = None
        for name, start, dur in spans:
            if start > a:
                break
            if start + dur > a:
                inner = name
        key = inner or 'outside the spans'
        idle[key] = idle.get(key, 0.0) + (b - a)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return dict(device_ops=[[n[:160], us / 1e6] for n, us in ops],
                idle_gaps=[[n, us / 1e6] for n, us in gaps])
