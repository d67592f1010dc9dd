"""The fused EGNN block (K3, K4, K5) under ``torch.func.vmap``.

K members of the block's inputs go through ``vmap`` of the port's
wrappers and must equal each member alone and ``jax.vmap`` of the JAX
package's ``fused_egnn_pairwise`` (and its ``jax.jvp``, whose rule is
``_jvp_op``), whose Pallas kernels run in interpret mode as
``tests/ops/test_pallas_egnn.py`` runs them: values, tangents and the
gradients of every argument. Where only the activations are mapped, K3
and K4 run once on the members' frames folded together; where the
weights are mapped too (an ensemble), once per member; K5 runs once per
member. The plain versions are swapped for counting copies to see it.
Then an ensemble of ``EGNNDynamics(pairwise='fused')``: its field and
tangent under ``ensemble_map``, and the gradient through
``make_ensemble_train_step``, against each member alone and the dense
path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfep_tpu.ops.pallas.egnn as jax_egnn
from tfep_tpu_torch.nn.dynamics import EGNNDynamics
from tfep_tpu_torch.nn.ensemble import (
    ensemble_init, ensemble_map, make_ensemble_train_step, stack_modules,
    unstack_module,
)
from tfep_tpu_torch.ops import egnn as E

from test_torch_common import (
    ATOL, CPU, DTYPE, GRAD_ATOL, close, t, torch_generator,
)
from test_torch_egnn_kernel import FEAT, N, R_CUTOFF, make_inputs

K = 3
NAMES = ('a_i', 'a_j', 'dist') + E.WEIGHTS + ('da_i', 'da_j', 'dd')


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jax_egnn, 'INTERPRET', True)


@pytest.fixture
def calls(monkeypatch):
    """Counting copies of the three plain versions: the batch size of
    each call, per kernel."""
    seen = {'k3': [], 'k4': [], 'k5': []}
    for name, key in (('pairwise_reference', 'k3'),
                      ('pairwise_jvp_reference', 'k4'),
                      ('pairwise_jvp_backward_reference', 'k5')):
        plain = getattr(E, name)

        def counted(*args, _plain=plain, _key=key):
            seen[_key].append(args[0].shape[0])
            return _plain(*args)

        monkeypatch.setattr(E, name, counted)
    return seen


def members(mapped_weights, seed=10):
    """K members' primals, tangents and cotangents (numpy, leading axis
    K); the weights are member 0's for every member unless
    ``mapped_weights``."""
    drawn = [make_inputs(seed + k) for k in range(K)]
    primals = [np.stack([d[0][i] for d in drawn]) for i in range(14)]
    if not mapped_weights:
        primals[3:] = [p[0] for p in primals[3:]]
    tangents = [np.stack([d[1][i] for d in drawn]) for i in range(3)]
    cots = [np.stack([d[2][i] for d in drawn]) for i in range(4)]
    return primals, tangents, cots


def in_dims(mapped_weights, n_tangents=0):
    return (0, 0, 0) + (0 if mapped_weights else None,) * 11 + \
        (0,) * n_tangents


def member(arrays, dims, k):
    return [a if d is None else a[k] for a, d in zip(arrays, dims)]


def jax_fused(*args):
    return jax_egnn.fused_egnn_pairwise(*args, N, FEAT, R_CUTOFF, 2)


def jax_jvp(*args):
    zeros = [jnp.zeros_like(p) for p in args[3:14]]
    (nm, mag), (dnm, dmag) = jax.jvp(jax_fused, args[:14],
                                     (*args[14:], *zeros))
    return nm, mag, dnm, dmag


@pytest.mark.parametrize('mapped_weights', [False, True])
def test_k3_under_vmap(calls, mapped_weights):
    primals, _, _ = members(mapped_weights)
    dims = in_dims(mapped_weights)
    with torch.no_grad():
        nm, mag = torch.func.vmap(
            lambda *a: E.egnn_pairwise(*a, R_CUTOFF), in_dims=dims)(
                *map(t, primals))
    assert calls['k3'] == ([K * 4] if not mapped_weights else [4] * K)
    nm_j, mag_j = jax.vmap(jax_fused, in_axes=dims)(*map(jnp.asarray,
                                                        primals))
    close(nm, nm_j, ATOL)
    close(mag, mag_j, ATOL)
    for k in range(K):
        with torch.no_grad():
            alone = E.egnn_pairwise(*map(t, member(primals, dims, k)),
                                    R_CUTOFF)
        close(nm[k], alone[0], ATOL)
        close(mag[k], alone[1], ATOL)


@pytest.mark.parametrize('mapped_weights', [False, True])
def test_k4_under_vmap(calls, mapped_weights):
    primals, tangents, _ = members(mapped_weights)
    dims = in_dims(mapped_weights, 3)
    args = primals + tangents
    outs = torch.func.vmap(
        lambda *a: E.egnn_pairwise_jvp(*a, R_CUTOFF), in_dims=dims)(
            *map(t, args))
    assert calls['k4'] == ([K * 4] if not mapped_weights else [4] * K)
    expected = jax.vmap(jax_jvp, in_axes=dims)(*map(jnp.asarray, args))
    for a, b in zip(outs, expected):
        close(a, b, ATOL)
    for k in range(K):
        alone = E.egnn_pairwise_jvp(*map(t, member(args, dims, k)),
                                    R_CUTOFF)
        for a, b in zip(outs, alone):
            close(a[k], b, ATOL)


def _jax_scalar(*args):
    cots = args[17:]
    return sum(jnp.sum(o * c) for o, c in zip(jax_jvp(*args[:17]), cots))


def _port_scalar(*args):
    outs = E.egnn_pairwise_jvp(*args[:17], R_CUTOFF)
    return sum(torch.sum(o * c) for o, c in zip(outs, args[17:]))


@pytest.mark.parametrize('mapped_weights', [False, True])
def test_k5_under_vmap_of_grad(calls, mapped_weights):
    """Per-member gradients of all 17 arguments (each member's own weight
    gradients, also where the weights are shared)."""
    primals, tangents, cots = members(mapped_weights)
    dims = in_dims(mapped_weights, 3) + (0,) * 4
    args = primals + tangents + cots
    grads = torch.func.vmap(
        torch.func.grad(_port_scalar, argnums=tuple(range(17))),
        in_dims=dims)(*map(t, args))
    assert calls['k5'] == [4] * K
    expected = jax.vmap(jax.grad(_jax_scalar, argnums=tuple(range(17))),
                        in_axes=dims)(*map(jnp.asarray, args))
    for name, a, b in zip(NAMES, grads, expected):
        assert a.shape == b.shape, name
        close(a, b, GRAD_ATOL)
    for k in range(K):
        leaves = [t(a).requires_grad_()
                  for a in member(args, dims, k)[:17]]
        outs = E.egnn_pairwise_jvp(*leaves, R_CUTOFF)
        alone = torch.autograd.grad(
            outs, leaves, [t(c[k]) for c in cots])
        for name, a, b in zip(NAMES, grads, alone):
            close(a[k], b, GRAD_ATOL)


def test_grad_of_vmap(calls):
    """Reverse mode over the mapped K4 (the CNF ensemble's loss): one
    backward through the per-member launches."""
    primals, tangents, cots = members(True)
    dims = in_dims(True, 3)
    leaves = [t(a).requires_grad_() for a in primals + tangents]
    outs = torch.func.vmap(lambda *a: E.egnn_pairwise_jvp(*a, R_CUTOFF),
                           in_dims=dims)(*leaves)
    grads = torch.autograd.grad(outs, leaves, [t(c) for c in cots])
    expected = jax.vmap(jax.grad(_jax_scalar, argnums=tuple(range(17))),
                        in_axes=dims + (0,) * 4)(
        *map(jnp.asarray, primals + tangents + cots))
    for a, b in zip(grads, expected):
        close(a, b, GRAD_ATOL)
    assert calls['k4'] == [4] * K and calls['k5'] == [4] * K


def test_mapped_r_cutoff_raises():
    primals, tangents, _ = members(False)
    dims = in_dims(False, 3) + (0,)
    with pytest.raises(ValueError, match='r_cutoff'):
        torch.func.vmap(E.egnn_pairwise_jvp, in_dims=dims)(
            *map(t, primals + tangents), torch.full((K,), R_CUTOFF,
                                                    dtype=DTYPE))


def test_second_derivative_raises():
    primals, tangents, cots = members(True)
    leaves = [t(a[0]).requires_grad_() for a in primals + tangents]
    outs = E.egnn_pairwise_jvp(*leaves, R_CUTOFF)
    grads = torch.autograd.grad(outs, leaves, [t(c[0]) for c in cots],
                                create_graph=True)
    with pytest.raises(RuntimeError, match='second'):
        torch.autograd.grad(grads[0].sum(), leaves[0])


# --------------------------------------------------------------------------
# An ensemble of EGNN fields on the fused path.
# --------------------------------------------------------------------------

N_ATOMS, BATCH, T = 5, 3, 0.3


def fields(pairwise, n=2):
    fields = []
    for k in range(n):
        field = EGNNDynamics.create(
            torch_generator(20 + k), [0, 1, 0, 1, 1], r_cutoff=3.0,
            time_feat_dim=4, node_feat_dim=8, distance_feat_dim=6,
            n_layers=2, initialize_identity=False, device=CPU, dtype=DTYPE,
            pairwise=pairwise)
        fields.append(field)
    return fields


def field_inputs():
    rng = np.random.default_rng(3)
    return (t(rng.normal(size=(BATCH, 3 * N_ATOMS))),
            t(rng.normal(size=(BATCH, 3 * N_ATOMS))))


def jvp_loss(field, x, v):
    f, df = field.forward_and_jvp(T, x, v)
    return torch.sum(f ** 2) + torch.sum(f * df)


def test_fused_field_ensemble(calls):
    fused = fields('fused')
    dense = fields('dense')
    stacked = stack_modules(fused)
    x, v = field_inputs()
    f, df = ensemble_map(lambda m, x, v: m.forward_and_jvp(T, x, v),
                         stacked, x, v)
    assert f.shape == df.shape == (2, BATCH, 3 * N_ATOMS)
    # Two layers, each once per member.
    assert calls['k4'] == [BATCH] * 4
    for k, (alone, plain) in enumerate(zip(fused, dense)):
        with torch.no_grad():
            f_k, df_k = alone.forward_and_jvp(T, x, v)
            f_p, df_p = plain.forward_and_jvp(T, x, v)
        close(f[k], f_k, ATOL)
        close(df[k], df_k, ATOL)
        close(f[k], f_p, ATOL)
        close(df[k], df_p, ATOL)
    with torch.no_grad():
        out = ensemble_map(lambda m, x: m(T, x), stacked, x)
    for k, alone in enumerate(fused):
        with torch.no_grad():
            close(out[k], alone(T, x), ATOL)


def test_fused_field_ensemble_gradient(calls):
    fused = fields('fused')
    stacked = stack_modules(fused)
    x, v = field_inputs()
    optimizer = ensemble_init(
        lambda p: torch.optim.SGD(p, lr=1e-2), stacked)
    step = make_ensemble_train_step(
        lambda m, b: jvp_loss(m, *b), optimizer)
    losses = step(stacked, (x, v))
    assert calls['k5'] == [BATCH] * 4
    for k, (alone, plain) in enumerate(zip(fused, fields('dense'))):
        loss = jvp_loss(alone, x, v)
        close(losses[k], loss.detach(), ATOL)
        params = list(alone.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        plain_grads = torch.autograd.grad(
            jvp_loss(plain, x, v), list(plain.parameters()),
            allow_unused=True)
        trained = unstack_module(stacked, k)
        for p, g, g_plain, q in zip(params, grads, plain_grads,
                                    trained.parameters()):
            g = torch.zeros_like(p) if g is None else g
            g_plain = torch.zeros_like(p) if g_plain is None else g_plain
            close(g, g_plain, GRAD_ATOL)
            close(q.detach(), (p - 1e-2 * g).detach(), GRAD_ATOL)
