"""Fixed-grid ODE solvers of the port against ``tfep_tpu.nn.ode``,
float64 on the CPU, with and without per-step recomputation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfep_tpu.nn import ode as jax_ode
from tfep_tpu_torch.nn import ode

from test_torch_common import ATOL, GRAD_ATOL, close, t

SOLVERS = ['euler', 'midpoint', 'rk4', 'dopri5']
RNG = np.random.default_rng(0)
W = 0.5 * RNG.normal(size=(5, 5))
X0 = RNG.normal(size=(3, 5))


def func(lib, w):
    """A nonlinear, time-dependent field on a (positions, scalar) state."""
    def f(time, state):
        x, _ = state
        v = lib.tanh(x @ w) * (1.0 + time)
        return v, lib.sum(v * x, -1)
    return f


@pytest.mark.parametrize('solver', SOLVERS)
@pytest.mark.parametrize('t0, t1', [(0.0, 1.0), (1.0, 0.0)])
def test_solvers_match_jax(solver, t0, t1):
    state0 = (X0, np.zeros(3))
    out_j = jax_ode.odeint(func(jnp, jnp.asarray(W)),
                           tuple(map(jnp.asarray, state0)), t0, t1,
                           n_steps=4, solver=solver, checkpoint=False)
    out_t = ode.odeint(func(torch, t(W)), tuple(map(t, state0)), t0, t1,
                       n_steps=4, solver=solver, checkpoint=False)
    for a, b in zip(out_t, out_j):
        close(a, b, ATOL)


@pytest.mark.parametrize('solver', SOLVERS)
def test_checkpoint_gives_the_same_gradients(solver):
    def loss_j(w):
        x, s = jax_ode.odeint(func(jnp, w), (jnp.asarray(X0), jnp.zeros(3)),
                              0.0, 1.0, n_steps=3, solver=solver)
        return jnp.sum(x ** 2) + jnp.sum(s)

    g_j = jax.grad(loss_j)(jnp.asarray(W))
    for checkpoint in (False, True):
        w = t(W).requires_grad_()
        x, s = ode.odeint(func(torch, w), (t(X0), torch.zeros(3,
                                                              dtype=w.dtype)),
                          0.0, 1.0, n_steps=3, solver=solver,
                          checkpoint=checkpoint)
        (g_t,) = torch.autograd.grad(torch.sum(x ** 2) + torch.sum(s), w)
        close(g_t, g_j, GRAD_ATOL)


def test_checkpoint_composes_with_jvp_inside_the_step():
    """torch.func.jvp inside a recomputed step (the CNF's integrand)."""
    v = t(RNG.normal(size=(3, 5)))
    grads = []
    for checkpoint in (False, True):
        w = t(W).requires_grad_()

        def f(time, state):
            x = state[0]
            vel, jv = torch.func.jvp(lambda z: torch.tanh(z @ w) * time,
                                     (x,), (v,))
            return vel, torch.sum(v * jv, -1)

        x, tr = ode.odeint(f, (t(X0), torch.zeros(3, dtype=w.dtype)), 0.0,
                           1.0, n_steps=3, solver='rk4',
                           checkpoint=checkpoint)
        grads.append(torch.autograd.grad(torch.sum(x ** 2) + torch.sum(tr),
                                         w)[0])
    close(grads[1], grads[0], GRAD_ATOL)


def test_unknown_solver_raises():
    with pytest.raises(ValueError, match='solver'):
        ode.odeint(func(torch, t(W)), (t(X0),), 0.0, 1.0, solver='rk45')
