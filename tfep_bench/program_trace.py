"""The program's own spans beside the device's operations.

``tfep_tpu_torch.utils.tracing`` records the port's spans on the clock
``torch.profiler`` gives the device's times in. :func:`join` adds them to
a compact trace (:mod:`tfep_bench.tracing`), with each device operation's
launch, under three more keys: ``program_spans``, every span the program
recorded, ``[name, start_us, duration_us, thread, parent, step, id,
thread_name]``; ``launches``, each device operation with the host call
that launched it, ``[name, start_us, duration_us, launch_start_us,
launch_duration_us, thread]``; and ``main_thread``. Threads are
``pthread_self`` cut to 32 bits, as CUPTI gives a launch's. The program's
spans from the threads that launch device work (all but the trainer's
pools, ``tfep-*``) also join ``spans``, so that
:func:`tfep_bench.tracing.breakdown` names an idle gap by the innermost of
them. :func:`attribute` puts each launched operation down to a program
span.

The harness does not call this module: ``tfep_bench/tests/card_spans.py``
does, and its tests hold it to traces recorded on the card.
"""

from __future__ import annotations

import bisect


def launch_events(prof):
    """``[name, start_us, duration_us, launch_start_us,
    launch_duration_us, thread]`` of every device operation of a finished
    profile whose launch the profile holds: the host call that launched it
    (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync`` and the
    like), found by the operation's correlation id."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    calls = {}
    for e in events:
        if e.device_type() != DeviceType.CUDA and e.name().startswith('cu'):
            calls.setdefault(e.correlation_id(), e)
    out = []
    for e in events:
        call = (calls.get(e.correlation_id())
                if e.device_type() == DeviceType.CUDA else None)
        if call is not None:
            out.append([e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3,
                        call.start_ns() / 1e3, call.duration_ns() / 1e3,
                        call.device_resource_id() & 0xFFFFFFFF])
    return sorted(out, key=lambda k: k[1])


def join(trace, program, launches, main_thread) -> dict:
    """``trace`` (a compact trace) with the program's spans (records of
    ``tfep_tpu_torch.utils.tracing``), the launches and the main thread's
    id."""
    spans = [[s.name, s.start_ns / 1e3, (s.end_ns - s.start_ns) / 1e3,
              s.thread & 0xFFFFFFFF, s.parent, s.step, s.id, s.thread_name]
             for s in program]
    joined = trace['spans'] + [s[:3] for s in spans
                               if not s[7].startswith('tfep-')]
    return dict(trace, spans=sorted(joined, key=lambda s: s[1]),
                program_spans=spans, launches=launches,
                main_thread=main_thread & 0xFFFFFFFF)


def program_spans(trace, name=None) -> list:
    """The program's span records (all, or those called ``name``); empty
    where the program recorded none."""
    return [s for s in trace.get('program_spans', ())
            if name is None or s[0] == name]


def self_us(trace, span) -> float:
    """A program span's own time: its duration less the part of it that its
    children cover."""
    start, end = span[1], span[1] + span[2]
    covered, last = 0.0, start
    for c in sorted((c for c in program_spans(trace) if c[4] == span[6]),
                    key=lambda c: c[1]):
        a, b = max(c[1], last), min(c[1] + c[2], end)
        if b > a:
            covered += b - a
            last = b
    return span[2] - covered


def attribute(trace) -> list:
    """``[(names, name, start_us, duration_us)]`` of every launched device
    operation in the window: ``names`` is the chain of program spans it is
    put down to, innermost first, or ``()``. An operation belongs to the
    innermost program span open on its launching thread when it was
    launched; where that thread had none open, to the main thread's
    innermost open span."""
    spans = program_spans(trace)
    by_id = {s[6]: s for s in spans}
    threads = {}
    for s in sorted(spans, key=lambda s: s[1]):
        threads.setdefault(s[3], []).append(s)
    starts = {t: [s[1] for s in ss] for t, ss in threads.items()}

    def innermost(thread, t):
        i = bisect.bisect_right(starts.get(thread, ()), t) - 1
        s = threads[thread][i] if i >= 0 else None
        # Spans of one thread nest: the innermost open one is the last to
        # start or one of its parents.
        while s is not None and not s[1] <= t < s[1] + s[2]:
            s = by_id.get(s[4])
        return s

    t0, t1 = trace['window']
    out = []
    for op, start, dur, launch, _, thread in trace.get('launches', ()):
        if not t0 <= start < t1:
            continue
        s = innermost(thread, launch)
        if s is None and thread != trace['main_thread']:
            s = innermost(trace['main_thread'], launch)
        names = []
        while s is not None:
            names.append(s[0])
            s = by_id.get(s[4])
        out.append((tuple(names), op, start, dur))
    return out
