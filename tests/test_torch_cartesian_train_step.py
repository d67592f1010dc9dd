"""The port's reference-frame slice against the JAX app's own flow stack.

A small JAX ``CartesianMAFMap`` (10 atoms, fixed atoms between mapped
ones, an origin atom, two axes atoms, PCA whitening, 2 spline-MAF layers)
is set up as ``tests/app/test_maps.py`` sets one up, and ``setup()`` builds
its flow. The port's stack is built twice: by hand from the port's flows,
with the JAX map's own index sets and the same frames for the PCA fit, and
by the port's own ``CartesianMAFMap.setup()`` on the same system. Loading
every leaf of the JAX flow with ``carry`` (no key missing or extra) shows
that each has the JAX stack's structure; then the map, its inverse and
three AdamW steps agree in float64 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfep_tpu.app import CartesianMAFMap
from tfep_tpu.io.topology import Topology
from tfep_tpu.io.traj import System
from tfep_tpu.nn.module import apply_updates, filter_value_and_grad, partition
from tfep_tpu.nn.transformers import NeuralSplineTransformer as JaxSpline
from tfep_tpu.units import ureg
from tfep_tpu_torch.app import CartesianMAFMap as PortCartesianMAFMap
from tfep_tpu_torch.convert import torch_name
from tfep_tpu_torch.io.topology import Topology as PortTopology
from tfep_tpu_torch.io.traj import System as PortSystem
from tfep_tpu_torch.loss import boltzmann_kl_div_loss
from tfep_tpu_torch.nn.conditioners.made import generate_degrees
from tfep_tpu_torch.nn.flows import (
    MAF, CenteredCentroidFlow, Flow, OrientedFlow, PartialFlow,
    PCAWhitenedFlow, SequentialFlow,
)
from tfep_tpu_torch.nn.transformers import NeuralSplineTransformer
from tfep_tpu_torch.ops import spline as ops_spline
from tfep_tpu_torch.units import ureg as port_ureg
from tfep_tpu_torch.utils.misc import atom_to_flattened_indices

from test_torch_common import (
    ATOL, CPU, DTYPE, carry, close, jax_state, perturb, t, torch_generator,
)

N_ATOMS, N_FRAMES, N_LAYERS, N_BINS, BATCH, N_STEPS = 10, 200, 2, 4, 32, 3
# Atoms 3 and 9 are fixed: 3 sits between mapped atoms, so every index
# past it shifts; the conditioning atom 6 and the axes atoms 2 and 5 too.
MAPPED, CONDITIONING, ORIGIN, AXES = [1, 2, 4, 5, 7, 8], [0, 6], 0, [2, 5]
LR = WEIGHT_DECAY = 1e-4
ON_CPU = dict(device=CPU, dtype=DTYPE)


class _MockPotential:
    """u(x) = sum(x), as in tests/app/test_maps.py."""
    energy_unit = ureg.kilocalorie_per_mole
    positions_unit = ureg.angstrom

    def __call__(self, x, cell=None):
        return jnp.sum(x, axis=-1)


def _positions():
    return np.random.default_rng(0).normal(size=(N_FRAMES, N_ATOMS, 3))


def _jax_map(tmp_path):
    topology = Topology(names=[f'C{i}' for i in range(N_ATOMS)],
                        elements=['C'] * N_ATOMS, resnames=['MOL'] * N_ATOMS,
                        resids=[1] * N_ATOMS)
    # The splines map the mapped atoms' DOFs less the three that fix the
    # axes atoms 2 and 5 (the origin atom 0 is a conditioning atom).
    n_mapped = 3 * len(MAPPED) - 3
    spline = JaxSpline.create(x0=-3.0 * jnp.ones(n_mapped),
                              xf=3.0 * jnp.ones(n_mapped), n_bins=N_BINS,
                              fused='never')
    tfep_map = CartesianMAFMap(
        potential_energy_func=_MockPotential(),
        temperature=300.0 * ureg.kelvin,
        system=System(topology, _positions()), batch_size=BATCH,
        tfep_logger_dir_path=str(tmp_path / 'logs'),
        mapped_atoms=MAPPED, conditioning_atoms=CONDITIONING,
        origin_atom=ORIGIN, axes_atoms=AXES, pca_whitening=True,
        n_maf_layers=N_LAYERS, flow_kwargs=dict(transformer=spline))
    tfep_map.setup()
    return tfep_map


class _Capture(Flow):
    """The identity, keeping what it sees: the frames as the MAF stack
    sees them, for the PCA fit."""

    def __init__(self):
        super().__init__()
        self.captured = []

    def forward(self, x):
        self.captured.append(x.detach().clone())
        return x, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)


def _port_stack(tfep_map, frames):
    """The stack of CartesianMAFMap.configure_flow and
    _wrap_reference_frame (tfep_tpu/app/cartesianmaf.py:109-173), PCA
    frames as _collect_maf_inputs takes them (:175-217), in the PartialFlow
    of create_partial_flow (tfep_tpu/app/base.py:233-241)."""
    conditioning = tfep_map.get_conditioning_indices(
        idx_type='dof', remove_fixed=True, remove_reference=True)
    origin, axes = tfep_map.get_reference_atoms_indices(
        remove_fixed=True, separate_origin_axes=True)
    axes = np.where(origin < axes, axes - 1, axes)
    n_total = 3 * tfep_map.n_nonfixed_atoms
    n_flow = tfep_map.n_nonfixed_dofs

    def wrap(flow):
        flow = OrientedFlow.create(
            flow, n_features=n_total - 3, axis_point_idx=int(axes[0]),
            plane_point_idx=int(axes[1]), axis='z', plane='xz', **ON_CPU)
        flow = CenteredCentroidFlow.create(
            flow, space_dimension=3, n_features=n_total,
            subset_point_indices=[int(origin)], **ON_CPU)
        return PartialFlow.create(
            flow, atom_to_flattened_indices(tfep_map._fixed_atom_indices),
            n_features=3 * N_ATOMS, device=CPU)

    generator = torch_generator(0)
    bound = 3.0 * np.ones(n_flow - len(conditioning))
    mafs = SequentialFlow.create(*[MAF.create(
        generator, generate_degrees(
            n_flow, conditioning_indices=conditioning,
            order='ascending' if i % 2 == 0 else 'descending'),
        transformer=NeuralSplineTransformer(-bound, bound, N_BINS, **ON_CPU),
        **ON_CPU) for i in range(N_LAYERS)], device=CPU)

    capture = _Capture()
    probe = wrap(capture)
    sample = np.unique(np.linspace(0, N_FRAMES - 1, min(
        N_FRAMES, tfep_map.pca_n_frames)).round().astype(np.int64))
    with torch.no_grad():
        for start in range(0, len(sample), 1024):
            probe(t(frames[sample[start:start + 1024]]))
    pca = PCAWhitenedFlow.create(mafs, torch.cat(capture.captured), **ON_CPU)
    return wrap(pca)


@pytest.fixture(scope='module')
def stacks(tmp_path_factory):
    tfep_map = _jax_map(tmp_path_factory.mktemp('cartesian'))
    # The dataset holds the frames in float32, and the JAX map fits its PCA
    # on those: both sides take them, in float64.
    frames = np.asarray(tfep_map.dataset.get_batch(np.arange(N_FRAMES))[
        'positions'], dtype=np.float64)
    close(frames, _positions().reshape(N_FRAMES, -1), atol=1e-6)
    stack = _port_stack(tfep_map, frames)
    # Perturbed: identity initialization zeroes every output gain.
    return perturb(tfep_map.flow, seed=1, scale=0.05), stack, frames


def test_structure_and_pca_fit(stacks):
    flow_j, stack, _ = stacks
    state = jax_state(flow_j)
    assert set(map(torch_name, state)) == set(
        dict(stack.named_parameters())) | set(dict(stack.named_buffers()))
    # The port's own PCA fit on its own captured frames, before any carry.
    for name in ('mean', 'whitening_matrix', 'blackening_matrix',
                 'whitening_log_det_J'):
        close(getattr(stack.flow.flow.flow, name),
              state[f'.flow.flow.flow.{name}'])


def test_map_and_three_adamw_steps_match_jax(stacks):
    flow_j, stack, frames = stacks
    _check_against_jax(flow_j, carry(flow_j, stack), frames)


def _check_against_jax(flow_j, stack, frames):
    """The carried stack's map, inverse and three AdamW steps against the
    JAX flow's."""
    assert stack.n_parameters() == flow_j.n_parameters()
    x = frames[:BATCH]

    x_t = t(x)
    with torch.no_grad():
        y_t, ldj_t = stack(x_t)
        x_back, ldj_inv = stack.inverse(y_t.clone())
    y_j, ldj_j = flow_j.forward(jnp.asarray(x))
    close(x_t, x, atol=0.0)
    close(y_t, y_j)
    close(ldj_t, ldj_j)
    close(x_back, x, atol=1e-8)
    close(ldj_inv, -ldj_t, atol=1e-8)
    # The fixed atoms pass through bit for bit.
    fixed = atom_to_flattened_indices([3, 9])
    close(y_t[:, fixed], x[:, fixed], atol=0.0)

    optimizer = optax.adamw(LR)
    opt_state = optimizer.init(partition(flow_j)[0])

    @jax.jit
    def step_j(flow, opt_state, x):
        def loss_fn(f):
            y, ldj = f.forward(x)
            return jnp.mean(0.5 * jnp.sum(y ** 2, axis=-1) - ldj)

        loss, grads = filter_value_and_grad(loss_fn)(flow)
        updates, opt_state = optimizer.update(grads, opt_state,
                                              partition(flow)[0])
        return apply_updates(flow, updates), opt_state, loss

    opt = torch.optim.AdamW(stack.parameters(), lr=LR,
                            weight_decay=WEIGHT_DECAY, eps=1e-8,
                            betas=(0.9, 0.999))
    ops_spline.LAUNCHES.reset()
    for _ in range(N_STEPS):
        flow_j, opt_state, loss_j = step_j(flow_j, opt_state, jnp.asarray(x))
        opt.zero_grad()
        y, ldj = stack(x_t)
        loss_t = boltzmann_kl_div_loss(0.5 * torch.sum(y ** 2, dim=-1), ldj)
        loss_t.backward()
        opt.step()
        close(loss_t, loss_j, ATOL)
    # The CPU runs the kernels' plain version, never a kernel.
    assert (ops_spline.LAUNCHES.forward, ops_spline.LAUNCHES.backward) == \
        (0, 0)

    trained = {torch_name(k): v for k, v in jax_state(flow_j).items()}
    for name, param in stack.named_parameters():
        close(param, trained[name], ATOL)
    for name, buf in stack.named_buffers():
        close(buf, trained[name], atol=0.0)


class _PortPotential:
    energy_unit = port_ureg.kilocalorie_per_mole

    def __call__(self, x, cell=None):
        return torch.sum(x, dim=-1)


@pytest.fixture(scope='module')
def map_stack(tmp_path_factory, stacks):
    """The stack of the port's own CartesianMAFMap.setup(), on the same
    system and with the same arguments as the JAX map."""
    n_mapped = 3 * len(MAPPED) - 3
    spline = NeuralSplineTransformer(-3.0 * np.ones(n_mapped),
                                     3.0 * np.ones(n_mapped), N_BINS,
                                     **ON_CPU)
    topology = PortTopology(names=[f'C{i}' for i in range(N_ATOMS)],
                            elements=['C'] * N_ATOMS,
                            resnames=['MOL'] * N_ATOMS, resids=[1] * N_ATOMS)
    tfep_map = PortCartesianMAFMap(
        potential_energy_func=_PortPotential(),
        temperature=300.0 * port_ureg.kelvin,
        system=PortSystem(topology, _positions()), batch_size=BATCH,
        tfep_logger_dir_path=str(tmp_path_factory.mktemp('port') / 'logs'),
        mapped_atoms=MAPPED, conditioning_atoms=CONDITIONING,
        origin_atom=ORIGIN, axes_atoms=AXES, pca_whitening=True,
        n_maf_layers=N_LAYERS, flow_kwargs=dict(transformer=spline),
        **ON_CPU)
    tfep_map.setup()
    return tfep_map.flow


def test_map_setup_builds_the_jax_stack(stacks, map_stack):
    flow_j, hand_built, _ = stacks
    state = jax_state(flow_j)
    assert set(map(torch_name, state)) == set(
        dict(map_stack.named_parameters())) | set(
        dict(map_stack.named_buffers()))
    # The map's own PCA fit and index buffers, before any carry, equal the
    # JAX map's and the hand-built stack's.
    hand_built_buffers = dict(hand_built.named_buffers())
    for name, buf in map_stack.named_buffers():
        close(buf, hand_built_buffers[name])
    for name in ('mean', 'whitening_matrix', 'blackening_matrix',
                 'whitening_log_det_J'):
        close(getattr(map_stack.flow.flow.flow, name),
              state[f'.flow.flow.flow.{name}'])


def test_map_setup_stack_matches_jax(stacks, map_stack):
    flow_j, _, frames = stacks
    _check_against_jax(flow_j, carry(flow_j, map_stack), frames)
