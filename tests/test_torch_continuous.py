"""The continuous flow of the port against ``tfep_tpu``, float64 on the
CPU: forward, inverse, the trace estimators, regularization, the
``create()`` checks, and the ``cnf_bench`` loss and its gradients. The
JAX probes (drawn from the flow's stored key) are fed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfep_tpu.ops.pallas.egnn as jax_egnn
from tfep_tpu.nn.dynamics import EGNNDynamics as JaxEGNN
from tfep_tpu.nn.dynamics import MaskedVelocityDynamics as JaxMasked
from tfep_tpu.nn.flows import ContinuousFlow as JaxCNF
from tfep_tpu.nn.module import filter_value_and_grad
from tfep_tpu_torch.convert import load_jax_state, torch_name
from tfep_tpu_torch.nn.dynamics import EGNNDynamics, MaskedVelocityDynamics
from tfep_tpu_torch.nn.flows import ContinuousFlow
from tfep_tpu_torch.ops import egnn as E

from test_torch_common import (
    ATOL, CPU, DTYPE, GRAD_ATOL, close, jax_state, perturb, t,
    torch_generator,
)

N, FEAT, DFEAT, TFEAT, LAYERS, BATCH = 6, 8, 10, 4, 2, 4
R_CUTOFF = 6.0
PAIRWISE = {'dense': 'xla', 'fused': 'pallas'}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jax_egnn, 'INTERPRET', True)


def carry_flow(jax_flow, port):
    """Load the JAX flow's leaves, less its raw probe key, into the port."""
    state = {k: v for k, v in jax_state(jax_flow).items()
             if k != '.hutchinson_key'}
    return load_jax_state(port, state)


def build(pairwise='dense', jax_pairwise=None, masked=False, **kwargs):
    node_types = np.arange(N) % 3
    common = dict(node_types=node_types, r_cutoff=R_CUTOFF,
                  time_feat_dim=TFEAT, node_feat_dim=FEAT,
                  distance_feat_dim=DFEAT, n_layers=LAYERS,
                  initialize_identity=False)
    dyn_j = JaxEGNN.create(jax.random.key(13),
                           pairwise=jax_pairwise or PAIRWISE[pairwise],
                           **common)
    dyn_t = EGNNDynamics.create(torch_generator(0), device=CPU, dtype=DTYPE,
                                pairwise=pairwise, **common)
    if masked:
        dyn_j = JaxMasked.create(dyn_j, [0, 4, 9], N * 3)
        dyn_t = MaskedVelocityDynamics.create(dyn_t, [0, 4, 9], N * 3,
                                              device=CPU, dtype=DTYPE)
    flow_j = perturb(JaxCNF.create(dyn_j, **kwargs), seed=2, scale=0.05)
    flow_t = carry_flow(flow_j, ContinuousFlow.create(dyn_t, device=CPU,
                                                      **kwargs))
    return flow_j, flow_t


def jax_probes(flow_j, x):
    key = jax.random.wrap_key_data(flow_j.hutchinson_key)
    return np.asarray(jax.random.normal(
        key, (flow_j.n_hutchinson_samples, *x.shape), dtype=jnp.float64))


def frames(seed=12):
    return 1.5 * np.random.default_rng(seed).normal(size=(BATCH, N * 3))


@pytest.mark.parametrize('pairwise', ['dense', 'fused'])
@pytest.mark.parametrize('inverse', [False, True])
@pytest.mark.parametrize('regularization', [True, False])
def test_pass_matches_jax(pairwise, inverse, regularization):
    # JAX's XLA formulation on both paths: the port's fused path is held
    # against JAX's Pallas kernels in test_torch_egnn_dynamics.py.
    flow_j, flow_t = build(pairwise, jax_pairwise='xla', solver='midpoint',
                           n_steps=2, regularization=regularization,
                           checkpoint=False)
    x = frames()
    fn = flow_j.inverse if inverse else flow_j.forward
    out_j = fn(jnp.asarray(x))
    with torch.no_grad():
        out_t = flow_t.integrate(t(x), t(jax_probes(flow_j, x)), inverse)
    assert len(out_t) == len(out_j) == (3 if regularization else 2)
    for a, b in zip(out_t, out_j):
        close(a, b, ATOL)


@pytest.mark.parametrize('trace_estimator, n_samples',
                         [('exact', 1), ('hutchinson', 3)])
def test_exact_and_multi_probe_traces(trace_estimator, n_samples):
    flow_j, flow_t = build('dense', masked=True,
                           trace_estimator=trace_estimator,
                           n_hutchinson_samples=n_samples, solver='euler',
                           n_steps=2, checkpoint=False)
    x = frames(3)
    eps = (None if trace_estimator == 'exact'
           else t(jax_probes(flow_j, x)))
    out_j = flow_j.forward(jnp.asarray(x))
    with torch.no_grad():
        out_t = flow_t.integrate(t(x), eps)
    for a, b in zip(out_t, out_j):
        close(a, b, ATOL)


def test_default_probes_are_seeded():
    _, flow_t = build('dense', solver='euler', n_steps=1)
    x = t(frames(4))
    with torch.no_grad():
        a = flow_t(x)
        b = flow_t(x)
        c = flow_t(x, generator=torch_generator(7))
    close(a[1], b[1].numpy(), 0.0)
    assert float((a[1] - c[1]).abs().max()) > 0.0
    assert flow_t.probes(x).shape == (1, *x.shape)


def test_create_refuses_the_kernel_path_with_probe_batches():
    dyn = EGNNDynamics.create(torch_generator(0), [0, 1], R_CUTOFF,
                              device=CPU, dtype=DTYPE, pairwise='fused')
    wrapped = MaskedVelocityDynamics.create(dyn, [0], 6, device=CPU)
    for dynamics in (dyn, wrapped):
        with pytest.raises(ValueError, match='fused'):
            ContinuousFlow.create(dynamics, trace_estimator='exact',
                                  device=CPU)
        with pytest.raises(ValueError, match='fused'):
            ContinuousFlow.create(dynamics, n_hutchinson_samples=4,
                                  device=CPU)
        ContinuousFlow.create(dynamics, device=CPU)  # supported
    with pytest.raises(ValueError, match='trace_estimator'):
        ContinuousFlow.create(dyn, trace_estimator='stochastic', device=CPU)


def _bench_loss_and_grads(flow_j, flow_t, x):
    """The cnf_bench loss, mean(0.5 |y|^2 - ldj) + 0.01 mean(reg), and its
    gradients on both sides, with the JAX probe."""
    def loss_fn(f):
        y, ldj, reg = f.forward(jnp.asarray(x))
        return (jnp.mean(0.5 * jnp.sum(y ** 2, -1) - ldj)
                + 0.01 * jnp.mean(reg))

    loss_j, grads_j = filter_value_and_grad(loss_fn)(flow_j)
    y, ldj, reg = flow_t.integrate(t(x), t(jax_probes(flow_j, x)))
    loss_t = (torch.mean(0.5 * torch.sum(y ** 2, -1) - ldj)
              + 0.01 * torch.mean(reg))
    params = dict(flow_t.named_parameters())
    grads_t = torch.autograd.grad(loss_t, list(params.values()),
                                  allow_unused=True)
    expected = {torch_name(k): v for k, v in jax_state(grads_j).items()}
    return loss_t, loss_j, dict(zip(params, grads_t)), expected


@pytest.mark.parametrize('pairwise, checkpoint', [
    ('dense', False), ('fused', False), ('fused', True)])
def test_bench_loss_and_every_gradient_match_jax(pairwise, checkpoint):
    """The configuration of tests/ops/test_pallas_egnn.py's CNF test; the
    port's fused path takes its K4/K5 plain versions and is held against
    JAX's XLA formulation."""
    flow_j, flow_t = build(pairwise, jax_pairwise='xla',
                           trace_estimator='hutchinson', solver='midpoint',
                           n_steps=2, regularization=True,
                           checkpoint=checkpoint)
    loss_t, loss_j, grads_t, grads_j = _bench_loss_and_grads(
        flow_j, flow_t, frames())
    close(loss_t, loss_j, ATOL)
    for name, g in grads_t.items():
        if g is None:
            # A size-0 (frozen) slot, or a weight the loss does not reach
            # (the last layer's feature update): JAX gives zeros.
            assert not np.any(grads_j[name])
        else:
            close(g, grads_j[name], GRAD_ATOL)


def test_fused_cnf_step_launches_no_kernel_on_the_cpu():
    _, flow_t = build('fused', solver='rk4', n_steps=1)
    E.LAUNCHES.reset()
    y, ldj, reg = flow_t(t(frames(5)))
    (0.5 * torch.sum(y ** 2) - ldj.sum() + reg.sum()).backward()
    assert (E.LAUNCHES.k3, E.LAUNCHES.k4, E.LAUNCHES.k5) == (0, 0, 0)
