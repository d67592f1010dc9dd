"""Host spans of the port, on the profiler's clock.

One recorder per process. While it is on (:func:`start` to :func:`stop`),
each :func:`span` and :func:`timed` block leaves a :class:`Span` record:
its name, its start and end, the thread, the span open around it on that
thread and the id of the step (or evaluation batch) it belongs to. Times
are ``time.time_ns()``, the clock ``torch.profiler`` stamps device activity
on, so a span and the device operations launched inside it lie on one time
axis. Records stay in memory until :func:`stop` returns them; the recorder
writes no file.

Off (the default), a :func:`span` costs one check of a module flag and
returns a shared no-op context: nothing is allocated, no clock is read and
no autograd node is added. :func:`timed` always adds its block's seconds to
a ``{name: [seconds, calls]}`` dict (``Trainer.host_seconds``), from the
same two clock reads as its span.

:func:`layer` spans a layer's call and, while the recorder is on and a
gradient is taken, its backward as ``<name>.backward``: an identity
``autograd.Function`` on the layer's differentiable outputs opens that span
when their gradient arrives, one on its differentiable inputs closes it.
The backward span lives on the thread autograd runs it on (on a card, the
device's autograd thread, which launches the backward kernels). A backward
span whose inputs take no gradient (a first layer fed the data) ends where
the next one opens on that thread, or at :func:`end_backward`.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import nullcontext
from typing import NamedTuple, Optional

import torch

__all__ = ['Span', 'start', 'stop', 'is_on', 'span', 'timed', 'set_step',
           'layer', 'end_backward']


class Span(NamedTuple):
    """A finished span. ``thread`` is the thread's ``threading.get_ident()``
    (``pthread_self``, which CUPTI gives a launch's thread by),
    ``native_thread`` its ``threading.get_native_id()`` (the profiler's
    rows of host operators), ``parent`` the ``id`` of the span open around
    it on that thread (``None`` at the top), ``step`` the id of the
    trainer's step or of the evaluation batch."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    native_thread: int
    thread_name: str
    parent: Optional[int]
    step: Optional[int]
    id: int


_on = False
_session = 0
_step = None
_records: list = []
# Per thread, the spans open on it: [id, name, start, parent, step,
# session, thread, native thread, thread name].
_open: dict = {}
# Per thread, the backward span a marker opened and no marker closed yet.
_pending: dict = {}
_ids = itertools.count()
_lock = threading.Lock()
_NOOP = nullcontext()


def is_on() -> bool:
    return _on


def start():
    """Turn the recorder on, with no records."""
    global _on, _session
    with _lock:
        _records.clear()
        _open.clear()
        _pending.clear()
        _session += 1
        _on = True


def stop() -> list:
    """Turn the recorder off; returns the records, spans still open closed
    at this moment."""
    global _on
    now = time.time_ns()
    with _lock:
        for stack in _open.values():
            for entry in stack:
                _record(entry, now)
        _open.clear()
        _pending.clear()
        _on = False
        records = sorted(_records, key=lambda s: s.start_ns)
        _records.clear()
    return records


def set_step(step: Optional[int]):
    """The step (or evaluation batch) that spans opened from now on belong
    to, unless they name their own."""
    global _step
    _step = step


def _record(entry, end):
    _records.append(Span(entry[1], entry[2], end, *entry[6:9], entry[3],
                         entry[4], entry[0]))


def _push(name, step, now):
    thread = threading.get_ident()
    native, thread_name = (threading.get_native_id(),
                           threading.current_thread().name)
    with _lock:
        stack = _open.setdefault(thread, [])
        entry = [next(_ids), name, now, stack[-1][0] if stack else None,
                 _step if step is None else step, _session, thread, native,
                 thread_name]
        stack.append(entry)
    return entry


def _pop(entry, now):
    """Close ``entry`` unless :func:`stop`, :func:`end_backward` or a later
    session has already."""
    with _lock:
        stack = _open.get(entry[6], ())
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is entry:
                del stack[i]
                if _on and entry[5] == _session:
                    _record(entry, now)
                return


class _Span:
    __slots__ = ('name', 'step', 'entry')

    def __init__(self, name, step):
        self.name, self.step = name, step

    def __enter__(self):
        self.entry = _push(self.name, self.step, time.time_ns())

    def __exit__(self, *exc):
        _pop(self.entry, time.time_ns())


def span(name: str, step: Optional[int] = None):
    """A ``with`` block recorded as the span ``name`` while the recorder is
    on; ``step`` overrides :func:`set_step`'s."""
    if not _on:
        return _NOOP
    return _Span(name, step)


class _Timed:
    __slots__ = ('totals', 'name', 'step', 'start', 'entry')

    def __init__(self, totals, name, step):
        self.totals, self.name, self.step = totals, name, step

    def __enter__(self):
        self.start = time.time_ns()
        self.entry = (_push(self.name, self.step, self.start) if _on
                      else None)

    def __exit__(self, *exc):
        end = time.time_ns()
        total = self.totals.setdefault(self.name, [0.0, 0])
        total[0] += (end - self.start) / 1e9
        total[1] += 1
        if self.entry is not None:
            _pop(self.entry, end)


def timed(totals: dict, name: str, step: Optional[int] = None):
    """A ``with`` block whose seconds and call are added to
    ``totals[name]`` (``[seconds, calls]``) always, and which is recorded
    as a span while the recorder is on."""
    return _Timed(totals, name, step)


# --------------------------------------------------------------------- #
# The backward of a layer.
# --------------------------------------------------------------------- #
def _marker_opens(name):
    if not _on:
        return
    now = time.time_ns()
    thread = threading.get_ident()
    previous = _pending.pop(thread, None)
    if previous is not None:
        _pop(previous, now)
    _pending[thread] = _push(name, None, now)


def _marker_closes(name):
    if not _on:
        return
    thread = threading.get_ident()
    entry = _pending.get(thread)
    if entry is not None and entry[1] == name:
        del _pending[thread]
        _pop(entry, time.time_ns())


def end_backward():
    """Close the backward spans that no input marker closed (call when the
    backward pass has returned)."""
    if not _on:
        return
    now = time.time_ns()
    for thread in list(_pending):
        entry = _pending.pop(thread, None)
        if entry is not None:
            _pop(entry, now)


class _Marker(torch.autograd.Function):
    """The identity on tensors (views, no copy); its backward calls
    ``hook(name)`` and passes the gradients on as they are."""

    @staticmethod
    def forward(ctx, hook, name, *tensors):
        ctx.hook, ctx.name = hook, name
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        ctx.hook(ctx.name)
        return (None, None, *grads)


def _marked(hook, name, values):
    """``values`` (a tuple) with a marker calling ``hook`` on the tensors
    that take a gradient; ``None`` when none does."""
    where = [i for i, v in enumerate(values)
             if isinstance(v, torch.Tensor) and v.requires_grad]
    if not where:
        return None
    out = list(values)
    for i, v in zip(where, _Marker.apply(hook, name,
                                         *(values[i] for i in where))):
        out[i] = v
    return tuple(out)


def layer(name: str, fn, *args):
    """``fn(*args)`` in the span ``name``. While the recorder is on, with
    gradients enabled and outside ``torch.func`` transforms, the layer's
    backward is recorded as ``<name>.backward`` (see the module's
    docstring); the values and gradients are those of ``fn(*args)``."""
    if not _on:
        return fn(*args)
    with _Span(name, None):
        if not torch.is_grad_enabled() or \
                torch._C._functorch.peek_interpreter_stack() is not None:
            return fn(*args)
        backward = name + '.backward'
        args = _marked(_marker_closes, backward, args) or args
        out = fn(*args)
        single = isinstance(out, torch.Tensor)
        marked = _marked(_marker_opens, backward, (out,) if single else out)
        if marked is None:
            return out
        return marked[0] if single else marked
