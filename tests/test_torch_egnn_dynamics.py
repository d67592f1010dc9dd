"""EGNN dynamics of the port against ``tfep_tpu``, float64 on the CPU:
``pairwise='dense'`` against JAX's ``'xla'`` and ``'fused'`` (the kernels'
plain versions here) against JAX's ``'pallas'`` (interpret mode), for the
primal and the dual pass ``forward_and_jvp`` that the CNF uses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfep_tpu.ops.pallas.egnn as jax_egnn
from tfep_tpu.nn.dynamics import EGNNDynamics as JaxEGNN
from tfep_tpu.nn.dynamics import MaskedVelocityDynamics as JaxMasked
from tfep_tpu_torch.nn.dynamics import EGNNDynamics, MaskedVelocityDynamics
from tfep_tpu_torch.ops import egnn as E

from test_torch_common import (
    ATOL, CPU, DTYPE, GRAD_ATOL, carry, close, perturb, t, torch_generator,
)

N, FEAT, DFEAT, TFEAT, LAYERS = 6, 8, 10, 4, 2
R_CUTOFF = 3.0
PAIRWISE = {'dense': 'xla', 'fused': 'pallas'}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jax_egnn, 'INTERPRET', True)


def build(pairwise, identity=False, seed=1):
    """The perturbed JAX dynamics and its port, with the same weights."""
    node_types = np.arange(N) % 3
    j = JaxEGNN.create(jax.random.key(9), node_types=node_types,
                       r_cutoff=R_CUTOFF, time_feat_dim=TFEAT,
                       node_feat_dim=FEAT, distance_feat_dim=DFEAT,
                       n_layers=LAYERS, initialize_identity=identity,
                       pairwise=PAIRWISE[pairwise])
    if not identity:
        j = perturb(j, seed=seed)
    p = EGNNDynamics.create(torch_generator(0), node_types=node_types,
                            r_cutoff=R_CUTOFF, time_feat_dim=TFEAT,
                            node_feat_dim=FEAT, distance_feat_dim=DFEAT,
                            n_layers=LAYERS, initialize_identity=identity,
                            device=CPU, dtype=DTYPE, pairwise=pairwise)
    return j, carry(j, p)


def frames(seed, batch=3):
    rng = np.random.default_rng(seed)
    # Spread so that some pairs fall beyond the 3.0 cutoff.
    return 1.5 * rng.normal(size=(batch, N * 3)), rng.normal(
        size=(batch, N * 3))


@pytest.mark.parametrize('pairwise', ['dense', 'fused'])
def test_primal_matches_jax(pairwise):
    j, p = build(pairwise)
    x, _ = frames(0)
    with torch.no_grad():
        close(p(0.3, t(x)), j(0.3, jnp.asarray(x)), ATOL)


@pytest.mark.parametrize('pairwise', ['dense', 'fused'])
@pytest.mark.parametrize('time', [0.0, 0.7])
def test_forward_and_jvp_matches_jax(pairwise, time):
    j, p = build(pairwise)
    x, v = frames(1)
    vel_j, jv_j = jax.jvp(lambda z: j(time, z), (jnp.asarray(x),),
                          (jnp.asarray(v),))
    vel_t, jv_t = p.forward_and_jvp(time, t(x), t(v))
    close(vel_t, vel_j, ATOL)
    close(jv_t, jv_j, ATOL)


def test_fused_dual_pass_gradients_match_dense():
    """Reverse mode through the fused dual pass (hand-derived K5 math on
    the CPU) equals autograd through torch.func.jvp of the dense path."""
    _, fused = build('fused')
    _, dense = build('dense')
    x, v = frames(2)
    grads = {}
    for name, net in (('fused', fused), ('dense', dense)):
        xt = t(x).requires_grad_()
        vel, jv = net.forward_and_jvp(0.4, xt, t(v))
        loss = torch.sum(vel ** 2) + torch.sum(jv * t(v)) + torch.sum(jv ** 2)
        params = [xt] + list(net.parameters())
        grads[name] = torch.autograd.grad(loss, params, allow_unused=True)
    for a, b in zip(grads['fused'], grads['dense']):
        if a is None or b is None:
            assert a is None and b is None
        else:
            close(a, b, GRAD_ATOL)


@pytest.mark.parametrize('pairwise', ['dense', 'fused'])
def test_sender_first_block_order(pairwise):
    """Only the sender block (the first) of the first message weight is
    nonzero: a port that swapped sender and receiver would differ."""
    j, p = build(pairwise)
    first = j.graph_layers[0].message_mlp.layers[0]
    w = first.weight.at[:, FEAT:2 * FEAT].set(0.0)
    j = j.replace(graph_layers=(j.graph_layers[0].replace(
        message_mlp=j.graph_layers[0].message_mlp.replace(layers=(
            first.replace(weight=w),
            *j.graph_layers[0].message_mlp.layers[1:]))),
        *j.graph_layers[1:]))
    carry(j, p)
    x, v = frames(3)
    vel_j, jv_j = jax.jvp(lambda z: j(0.5, z), (jnp.asarray(x),),
                          (jnp.asarray(v),))
    vel_t, jv_t = p.forward_and_jvp(0.5, t(x), t(v))
    close(vel_t, vel_j, ATOL)
    close(jv_t, jv_j, ATOL)
    # The swapped order gives another field.
    with torch.no_grad():
        w_t = p.graph_layers[0].message_mlp.layers[0].weight
        w_t[:, :2 * FEAT] = torch.cat([w_t[:, FEAT:2 * FEAT],
                                       w_t[:, :FEAT]], dim=1)
        assert float((p(0.5, t(x)) - t(np.asarray(vel_j))).abs().max()) > 1e-3


def test_identity_initialization_gives_zero_velocity():
    _, p = build('fused', identity=True)
    x, v = frames(4)
    vel, jv = p.forward_and_jvp(0.2, t(x), t(v))
    assert float(vel.abs().max()) == 0.0 and float(jv.abs().max()) == 0.0


@pytest.mark.parametrize('pairwise', ['dense', 'fused'])
def test_masked_velocity_dynamics(pairwise):
    j, p = build(pairwise)
    zero = [0, 1, 2, 7, 17]
    jm = JaxMasked.create(j, zero, N * 3)
    pm = MaskedVelocityDynamics.create(p, zero, N * 3, device=CPU,
                                       dtype=DTYPE)
    x, v = frames(5)
    vel_j, jv_j = jax.jvp(lambda z: jm(0.6, z), (jnp.asarray(x),),
                          (jnp.asarray(v),))
    vel_t, jv_t = pm.forward_and_jvp(0.6, t(x), t(v))
    close(vel_t, vel_j, ATOL)
    close(jv_t, jv_j, ATOL)
    assert float(vel_t[:, zero].abs().max()) == 0.0
    with torch.no_grad():
        close(pm(0.6, t(x)), vel_j, ATOL)


def test_fused_plain_call_has_no_gradient():
    _, p = build('fused')
    x, _ = frames(6)
    with pytest.raises(RuntimeError, match='no gradient'):
        p(0.1, t(x))
    E.LAUNCHES.reset()
    with torch.no_grad():
        p(0.1, t(x))
    # The CPU runs the plain version, never a kernel.
    assert (E.LAUNCHES.k3, E.LAUNCHES.k4, E.LAUNCHES.k5) == (0, 0, 0)


def test_options_not_ported_or_unknown_raise():
    with pytest.raises(NotImplementedError):
        EGNNDynamics.create(torch_generator(0), [0, 1], 3.0, device=CPU,
                            compute_dtype='bfloat16')
    with pytest.raises(ValueError, match='pairwise'):
        EGNNDynamics.create(torch_generator(0), [0, 1], 3.0, device=CPU,
                            pairwise='pallas')
