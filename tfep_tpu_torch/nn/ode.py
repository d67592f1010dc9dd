"""Fixed-grid ODE integrators for continuous flows.

Port of ``tfep_tpu/nn/ode.py``: fixed-step solvers over a tuple of
tensors, rolled as a Python loop (the JAX package's ``lax.scan``), with
each step optionally recomputed in the backward pass
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``).
Reverse mode through the loop gives exact discretize-then-optimize
gradients.

Solvers: ``euler``, ``midpoint``, ``rk4``, and ``dopri5`` (the Dormand-
Prince 5th-order tableau on a fixed grid).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

__all__ = ['odeint', 'SOLVERS']

# Dormand-Prince 5(4) Butcher tableau (5th-order solution weights).
_DOPRI5_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
]
_DOPRI5_B = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_DOPRI5_C = [0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0]


def _axpy(a, x, y):
    """y + a * x over tuples."""
    return tuple(yi + a * xi for xi, yi in zip(x, y))


def _scale_sum(coeffs, states, base):
    out = base
    for c, state in zip(coeffs, states):
        if c != 0.0:
            out = _axpy(c, state, out)
    return out


def _zeros(state):
    return tuple(torch.zeros_like(s) for s in state)


def _step_euler(func, t, dt, state):
    return _axpy(dt, func(t, state), state)


def _step_midpoint(func, t, dt, state):
    k1 = func(t, state)
    k2 = func(t + dt / 2, _axpy(dt / 2, k1, state))
    return _axpy(dt, k2, state)


def _step_rk4(func, t, dt, state):
    k1 = func(t, state)
    k2 = func(t + dt / 2, _axpy(dt / 2, k1, state))
    k3 = func(t + dt / 2, _axpy(dt / 2, k2, state))
    k4 = func(t + dt, _axpy(dt, k3, state))
    incr = _scale_sum([1 / 6, 1 / 3, 1 / 3, 1 / 6], [k1, k2, k3, k4],
                      _zeros(state))
    return _axpy(dt, incr, state)


def _step_dopri5(func, t, dt, state):
    ks = []
    for stage in range(6):
        incr = _scale_sum(_DOPRI5_A[stage], ks, _zeros(state))
        ks.append(func(t + _DOPRI5_C[stage] * dt, _axpy(dt, incr, state)))
    incr = _scale_sum(_DOPRI5_B, ks, _zeros(state))
    return _axpy(dt, incr, state)


SOLVERS = {
    'euler': _step_euler,
    'midpoint': _step_midpoint,
    'rk4': _step_rk4,
    'dopri5': _step_dopri5,
}


def odeint(func: Callable, state0, t0: float, t1: float, n_steps: int = 20,
           solver: str = 'dopri5', checkpoint: bool = True):
    """Integrate ``d state/dt = func(t, state)`` from t0 to t1.

    Parameters
    ----------
    func : callable
        ``func(t, state) -> d state/dt``, with ``t`` a Python float and
        ``state`` a tuple of tensors.
    state0 : tuple of torch.Tensor
    t0, t1 : float
        Integration bounds (t1 < t0 integrates backward).
    n_steps : int, optional
        Number of fixed steps (the grid is uniform).
    solver : str, optional
        One of ``'euler'``, ``'midpoint'``, ``'rk4'``, ``'dopri5'``.
    checkpoint : bool, optional
        Recompute each step in the backward pass instead of keeping its
        intermediates.

    Returns
    -------
    tuple of torch.Tensor
        The state at ``t1``.
    """
    if solver not in SOLVERS:
        raise ValueError(
            f"solver must be one of {sorted(SOLVERS)}, got {solver!r}")
    step_fn = SOLVERS[solver]
    dt = (t1 - t0) / n_steps
    state = tuple(state0)
    for i in range(n_steps):
        t = t0 + i * dt
        if checkpoint:
            state = _checkpoint(
                lambda *s, t=t: step_fn(func, t, dt, s), *state,
                use_reentrant=False)
        else:
            state = step_fn(func, t, dt, state)
    return state
