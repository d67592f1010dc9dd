"""The port's Z-matrix conversion (``ops/zmatrix.py``) and
``CartesianToMixedFlow`` against the JAX package's.

Mirrors ``tests/ops/test_zmatrix.py``: both directions of the conversion
on a chain and on random trees, values and gradients against JAX in
float64 on the CPU (``ATOL``, gradients ``GRAD_ATOL``), the round trip,
the log-det against the port's autograd oracle, the JAX package's padded
placement plan built identically, and the row-order error. The conversion
flow wraps a perturbed MAF carried from JAX (no leaf missing or extra):
forward, inverse and gradients against JAX, the round trip and the full
map's log-det against the oracle ``batch_log_abs_det_J``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfep_tpu.nn.conditioners.made import generate_degrees
from tfep_tpu.nn.flows import MAF as JaxMAF
from tfep_tpu.nn.flows.cartmixed import CartesianToMixedFlow as JaxC2M
from tfep_tpu.nn.module import filter_value_and_grad
from tfep_tpu.ops import zmatrix as jzm
from tfep_tpu_torch.convert import torch_name
from tfep_tpu_torch.nn.flows import MAF, CartesianToMixedFlow
from tfep_tpu_torch.ops import zmatrix as zm
from tfep_tpu_torch.utils.math import batch_log_abs_det_J

from test_torch_common import (
    CPU, DTYPE, GRAD_ATOL, carry, close, jax_state, perturb, t,
    torch_generator,
)

BATCH = 4
# 3 Cartesian reference atoms (0, 1, 2) + 4 IC atoms in a chain.
CHAIN = np.array([[3, 0, 1, 2], [4, 3, 0, 1], [5, 4, 3, 0], [6, 5, 4, 3]])
N_ATOMS = 7


def chain_positions(seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    base = np.arange(N_ATOMS)[:, None] * np.array([1.2, 0.3, -0.2])
    return base + 0.4 * rng.normal(size=(batch, N_ATOMS, 3))


def random_z_matrix(rng, n_atoms):
    """A valid random Z-matrix over atoms 3..n-1 (0, 1, 2 Cartesian): each
    atom bonds to a random placed parent, with two further distinct placed
    atoms as references, so the levels are those of random trees."""
    rows = []
    for i in range(3, n_atoms):
        placed = np.arange(i)
        parent = int(rng.choice(placed))
        others = rng.choice(placed[placed != parent], size=2, replace=False)
        rows.append([i, parent, int(others[0]), int(others[1])])
    return np.array(rows)


def tree_case(seed, n_atoms, batch=3):
    """A random tree's Z-matrix and positions built from safe internal
    coordinates (through the JAX package's reconstruction)."""
    rng = np.random.default_rng(seed)
    z = random_z_matrix(rng, n_atoms)
    n_ic = len(z)
    ref = np.array([[0.0, 0.0, 0.0], [1.3, 0.0, 0.0], [0.6, 1.1, 0.2]])
    ref = ref[None] + 0.05 * rng.normal(size=(batch, 3, 3))
    init = jnp.zeros((batch, n_atoms, 3)).at[:, :3].set(ref)
    x, _ = jzm.internal_to_cartesian(
        jnp.asarray(rng.uniform(0.9, 1.6, (batch, n_ic))),
        jnp.asarray(rng.uniform(0.6, 2.5, (batch, n_ic))),
        jnp.asarray(rng.uniform(-3.0, 3.0, (batch, n_ic))), init, z,
        normalize_angles=False)
    return z, np.asarray(x)


CASES = [('chain', CHAIN, chain_positions()),
         ('tree-5', *tree_case(0, 5)), ('tree-9', *tree_case(1, 9))]


@pytest.mark.parametrize('normalize', [False, True])
@pytest.mark.parametrize('name,z,x', CASES, ids=[c[0] for c in CASES])
def test_cartesian_to_internal(name, z, x, normalize):
    def measure(y):
        return jzm.cartesian_to_internal(y, z, normalize_angles=normalize)

    ref = jax.jit(measure)(jnp.asarray(x))
    xt = t(x).requires_grad_()
    out = zm.cartesian_to_internal(xt, torch.as_tensor(z),
                                   normalize_angles=normalize)
    for a, b in zip(out, ref):
        close(a, b)
    if normalize:
        for ic in out[1:3]:
            assert bool(((ic >= 0) & (ic <= 1)).all())

    def loss(values, lib):
        return sum(lib.sum(v ** 2) for v in values)

    grad_j = jax.jit(jax.grad(lambda y: loss(measure(y), jnp)))(
        jnp.asarray(x))
    (grad_t,) = torch.autograd.grad(loss(out, torch), xt)
    close(grad_t, grad_j, GRAD_ATOL)


@pytest.mark.parametrize('normalize', [False, True])
@pytest.mark.parametrize('name,z,x', CASES, ids=[c[0] for c in CASES])
def test_internal_to_cartesian(name, z, x, normalize):
    """The reconstruction from the Cartesian atoms against JAX's, the
    gradients with respect to every internal coordinate and the Cartesian
    atoms, and the round trip to the input."""
    n_atoms = x.shape[1]
    bonds, angles, torsions, ldj = jzm.cartesian_to_internal(
        jnp.asarray(x), z, normalize_angles=normalize)
    cart = np.setdiff1d(np.arange(n_atoms), z[:, 0])
    init = np.zeros_like(x)
    init[:, cart] = x[:, cart]

    def loss(out, lib):
        return lib.sum(out[0] ** 3) + lib.sum(out[1] ** 2)

    def jax_fn(args):
        return loss(jzm.internal_to_cartesian(
            *args, z, normalize_angles=normalize), jnp)

    primals = (bonds, angles, torsions, jnp.asarray(init))
    grads_j = jax.jit(jax.grad(jax_fn))(primals)
    out_j = jax.jit(lambda args: jzm.internal_to_cartesian(
        *args, z, normalize_angles=normalize))(primals)

    args = [t(a).requires_grad_() for a in primals]
    out_t = zm.internal_to_cartesian(*args, torch.as_tensor(z),
                                     normalize_angles=normalize)
    close(out_t[0], out_j[0])
    close(out_t[1], out_j[1])
    close(out_t[0], x, 1e-9)    # the round trip
    close(out_t[1] + t(ldj), 0.0, 1e-9)
    grads_t = torch.autograd.grad(loss(out_t, torch), args)
    for a, b in zip(grads_t, grads_j):
        close(a, b, GRAD_ATOL)


@pytest.mark.parametrize('name,z,x', CASES, ids=[c[0] for c in CASES])
def test_log_det_against_the_oracle(name, z, x):
    """log|det| of (IC atoms' Cartesians -> bonds, angles, torsions)
    against the autograd oracle, one frame at a time."""
    ic_atoms = torch.as_tensor(z[:, 0])
    x_t = t(x)

    def oracle(frame):
        def to_ic(x_ic):
            full = frame[None].index_copy(1, ic_atoms,
                                          x_ic.reshape(1, -1, 3))
            return torch.cat(zm.cartesian_to_internal(full, z)[:3], dim=-1)

        return batch_log_abs_det_J(to_ic, frame[ic_atoms].reshape(1, -1))

    oracle = torch.cat([oracle(frame) for frame in x_t])
    close(zm.cartesian_to_internal(x_t, z)[3], oracle, 1e-8)


@pytest.mark.parametrize('name,z,x', CASES, ids=[c[0] for c in CASES])
def test_placement_schedule(name, z, x):
    """The JAX package's padded plan, and the port's unpadded levels that
    place each row once, after its references."""
    n_atoms = x.shape[1]
    for a, b in zip(zm.build_placement_schedule(z, n_atoms),
                    jzm.build_placement_schedule(z, n_atoms)):
        np.testing.assert_array_equal(a, np.asarray(b))
    schedule = zm.PlacementSchedule(z, n_atoms, device=CPU)
    assert schedule.n_levels == len(jzm.build_placement_schedule(
        z, n_atoms)[0])
    placed = set(np.setdiff1d(np.arange(n_atoms), z[:, 0]).tolist())
    rows_seen = []
    for targets, refs, rows in schedule.levels:
        np.testing.assert_array_equal(targets, z[rows, 0])
        np.testing.assert_array_equal(refs, z[rows, 1:].reshape(-1))
        assert set(refs.tolist()) <= placed
        placed |= set(targets.tolist())
        rows_seen += rows.tolist()
    assert sorted(rows_seen) == list(range(len(z)))


def test_forward_reference_z_matrix_rejected():
    """Rows out of dependency order raise, not reconstruct garbage."""
    z = np.array([[5, 6, 1, 2], [6, 1, 2, 0]])
    with pytest.raises(ValueError, match='dependency order'):
        zm.build_placement_schedule(z, n_atoms=7)
    with pytest.raises(ValueError, match='dependency order'):
        zm.PlacementSchedule(z, n_atoms=7, device=CPU)


def test_schedule_follows_the_module():
    """The levels move with the flow and stay out of its state."""
    schedule = zm.PlacementSchedule(CHAIN, N_ATOMS, device=CPU)
    assert sorted(schedule.state_dict()) == ['0', '1', '2']
    schedule = schedule.to(torch.float32)
    assert all(t_.dtype == torch.int64 for level in schedule.levels
               for t_ in level)


# =============================================================================
# CartesianToMixedFlow
# =============================================================================

# 9 atoms: atoms 0-5 in the Z-matrix chain below, 6-8 Cartesian with the
# reference atoms 6 (origin), 7 (axis) and 8 (plane).
C2M_Z = np.array([[0, 6, 7, 8], [1, 0, 6, 7], [2, 1, 0, 6], [3, 2, 1, 0],
                  [4, 3, 2, 1], [5, 4, 3, 2]])
C2M_ATOMS = 11
C2M_CARTESIAN = [6, 7, 8, 9, 10]
C2M_REFERENCE = [6, 7, 8]


def c2m_positions(seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    turns = np.arange(C2M_ATOMS) * 1.2
    base = np.stack([1.5 * np.cos(turns), 1.5 * np.sin(turns),
                     0.3 * np.arange(C2M_ATOMS)], axis=1)
    return (base + 0.05 * rng.normal(size=(batch, C2M_ATOMS, 3))).reshape(
        batch, -1)


def c2m_pair(remove, seed=0):
    """The conversion around a perturbed MAF on both sides."""
    conv_j = JaxC2M.create(None, C2M_CARTESIAN, C2M_Z, C2M_REFERENCE, remove)
    conv_t = CartesianToMixedFlow.create(None, C2M_CARTESIAN, C2M_Z,
                                         C2M_REFERENCE, remove, device=CPU)
    assert conv_t.n_dofs_out == conv_j.n_dofs_out
    # The kept-constant reference DOFs are conditioning, as MixedMAFMap
    # makes them: a flow that moved them would not round-trip.
    reference = conv_j.get_dof_indices_by_type()['reference']
    degrees = generate_degrees(conv_j.n_dofs_out, conditioning_indices=(
        reference if len(reference) else None))
    maf_j = perturb(JaxMAF.create(jax.random.key(seed), degrees),
                    seed=seed + 10, scale=0.05)
    flow_j = conv_j.replace(flow=maf_j)
    conv_t.flow = MAF.create(torch_generator(seed), degrees, device=CPU,
                             dtype=DTYPE)
    return flow_j, carry(flow_j, conv_t)


REMOVE = [(True, True, True), (False, False, False), (False, True, False)]


@pytest.mark.parametrize('remove', REMOVE)
def test_cartesian_to_mixed_flow(remove):
    flow_j, flow_t = c2m_pair(remove)
    x = c2m_positions()
    # jit: JAX's eager dispatch of the placement loop takes seconds.
    y_j, ldj_j = jax.jit(flow_j.forward)(jnp.asarray(x))
    with torch.no_grad():
        y_t, ldj_t = flow_t(t(x))
        x_t, ildj_t = flow_t.inverse(y_t)
    close(y_t, y_j)
    close(ldj_t, ldj_j)
    x_j, ildj_j = jax.jit(flow_j.inverse)(y_j)
    close(x_t, x_j)
    close(ildj_t, ildj_j)
    close(x_t, x, 1e-9)
    close(ldj_t + ildj_t, 0.0, 1e-9)
    close(batch_log_abs_det_J(lambda z: flow_t(z)[0], t(x)), ldj_t, 1e-8)

    # Mixed coordinates and DOF groups.
    mixed_j = jax.jit(flow_j.cartesian_to_mixed)(jnp.asarray(x))
    with torch.no_grad():
        mixed_t = flow_t.cartesian_to_mixed(t(x))
    for a, b in zip(mixed_t, mixed_j):
        close(a, b)
    for cond in (None, [9], [7, 10], [8]):
        groups_j = flow_j.get_dof_indices_by_type(cond)
        groups_t = flow_t.get_dof_indices_by_type(cond)
        assert sorted(groups_t) == sorted(groups_j)
        for key, value in groups_j.items():
            if value is None:
                assert groups_t[key] is None
            else:
                np.testing.assert_array_equal(groups_t[key], value)


def test_cartesian_to_mixed_flow_gradients():
    flow_j, flow_t = c2m_pair((False, False, False), seed=3)
    x = c2m_positions(seed=4)

    def loss_j(f):
        y, ldj = f.forward(jnp.asarray(x))
        return jnp.sum(y ** 2) + jnp.sum(ldj)

    _, grads = jax.jit(filter_value_and_grad(loss_j))(flow_j)
    expected = {torch_name(k): v for k, v in jax_state(grads).items()}
    y, ldj = flow_t(t(x))
    (torch.sum(y ** 2) + torch.sum(ldj)).backward()
    for name, param in flow_t.named_parameters():
        close(param.grad, expected[name], GRAD_ATOL)


def test_cartesian_to_mixed_flow_float32_on_the_cpu():
    """The buffers and the levels follow ``.to``; a float32 copy maps as
    the float64 one to float32 rounding."""
    _, flow_t = c2m_pair((True, True, True))
    x = t(c2m_positions())
    y64, _ = flow_t(x)
    y32, _ = flow_t.to(torch.float32)(x.float())
    close(y32.double(), y64.detach(), 1e-4)
