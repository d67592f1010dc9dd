"""Parallelization strategies for per-sample engine fan-out (host side).

A copy of ``tfep_tpu/parallel/strategies.py``: the port keeps its own,
because importing the JAX package's module would import JAX.

Each batch of mapped coordinates reaching an external-engine potential is
split into per-frame single-point calculations; a strategy decides how they
are distributed: in-process (serial), over a process pool, or over a
thread pool (right for engines that release the GIL or subprocess-based
engines, and composes with the asynchronous card without pickling).
Reference behavior: upstream tfep/utils/parallel.py:37-132.
"""

from __future__ import annotations

import abc
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List

__all__ = ['ParallelizationStrategy', 'SerialStrategy',
           'ProcessPoolStrategy', 'ThreadPoolStrategy']


class ParallelizationStrategy(abc.ABC):
    """Contract: ``run(func, args) -> [func(*args[i]) for i]``."""

    @abc.abstractmethod
    def run(self, func: Callable, args: Iterable) -> List:
        """Distribute ``func`` over the argument tuples and collect results."""


class SerialStrategy(ParallelizationStrategy):
    """In-process loop (the default everywhere)."""

    def run(self, func, args):
        return [func(*arg) for arg in args]


class ProcessPoolStrategy(ParallelizationStrategy):
    """Fan out over a ``multiprocessing.Pool`` via ``starmap``.

    The pool is owned by the caller (engines like psi4 need custom pool
    initializers because their handles are not picklable, cf.
    upstream tfep/potentials/psi4.py:369-375).

    On a machine with a CUDA card the pool must come from
    ``multiprocessing.get_context('spawn')``: a worker forked after CUDA
    has initialized in the parent deadlocks on its first CUDA call (and
    may hang in the fork itself). The task functions of the engine
    wrappers are module-level and their modules touch no CUDA at import,
    so a spawned worker can unpickle them.
    """

    def __init__(self, pool):
        self.pool = pool

    def run(self, func, args):
        return self.pool.starmap(func, args)


class ThreadPoolStrategy(ParallelizationStrategy):
    """Fan out over threads.

    Appropriate for subprocess-launching engines (GROMACS, CPMD) and
    GIL-releasing bindings: no pickling, shares engine caches, and overlaps
    naturally with the device stream while the host waits on I/O.
    """

    def __init__(self, max_workers: int = None):
        self._executor = ThreadPoolExecutor(max_workers=max_workers)

    def run(self, func, args):
        futures = [self._executor.submit(func, *arg) for arg in args]
        return [f.result() for f in futures]

    def shutdown(self):
        self._executor.shutdown()
