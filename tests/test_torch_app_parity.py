"""The port's ``CartesianMAFMap`` + ``Trainer`` against the JAX package's.

Both packages build the map of ``tests/test_torch_cartesian_train_step.py``
(10 atoms, fixed atoms 3 and 9 between mapped ones, an origin atom, two
axes atoms, PCA whitening, 2 spline-MAF layers) on the same ``System``, in
float64 on the CPU. The JAX map's weights are perturbed (identity
initialization would compare the identity with itself) and carried into
the port's map with ``carry`` (no key missing or extra). Then each
package's ``Trainer`` takes 3 steps with ``shuffle_seed=0``, and the two
runs must agree: the batch order, each step's logged per-sample
``potential`` and ``log_det_J``, ``loss_history``, the final weights and
``run_evaluation``'s tensors. ``training_step_fn`` is also held against
JAX's on each of its branches (log-weights, a bias, ignored NaNs, a
regularization term). Values are held at 1e-10 and weights at 1e-9, as
the JAX package's own tests hold forward values and gradients.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfep_tpu.app as jax_app
import tfep_tpu.io.topology as jax_topology
import tfep_tpu.io.traj as jax_traj
import tfep_tpu.units as jax_units
from tfep_tpu.nn.transformers import NeuralSplineTransformer as JaxSpline
from tfep_tpu_torch.app import CartesianMAFMap, Trainer
from tfep_tpu_torch.convert import torch_name
from tfep_tpu_torch.io.topology import Topology
from tfep_tpu_torch.io.traj import System
from tfep_tpu_torch.nn.transformers import NeuralSplineTransformer
from tfep_tpu_torch.ops import spline as ops_spline
from tfep_tpu_torch.units import ureg

from test_torch_common import (
    ATOL, CPU, DTYPE, GRAD_ATOL, carry, close, jax_state, perturb,
)

N_ATOMS, N_FRAMES, N_LAYERS, N_BINS, BATCH, N_STEPS = 10, 200, 2, 4, 32, 3
MAPPED, CONDITIONING, ORIGIN, AXES = [1, 2, 4, 5, 7, 8], [0, 6], 0, [2, 5]
# The splines map the mapped atoms' DOFs less the three that fix the axes
# atoms 2 and 5.
N_MAPPED_DOFS = 3 * len(MAPPED) - 3


class _JaxPotential:
    """u(x) = sum(x) in kcal/mol, as in tests/app/test_maps.py."""
    energy_unit = jax_units.ureg.kilocalorie_per_mole

    def __call__(self, x, cell=None):
        return jnp.sum(x, axis=-1)


class _PortPotential:
    """The same potential on torch tensors."""
    energy_unit = ureg.kilocalorie_per_mole

    def __call__(self, x, cell=None):
        return torch.sum(x, dim=-1)


def _frames():
    return np.random.default_rng(0).normal(size=(N_FRAMES, N_ATOMS, 3))


def _topology_kwargs():
    return dict(names=[f'C{i}' for i in range(N_ATOMS)],
                elements=['C'] * N_ATOMS, resnames=['MOL'] * N_ATOMS,
                resids=[1] * N_ATOMS)


def _map_kwargs(path):
    return dict(temperature=300.0, batch_size=BATCH,
                tfep_logger_dir_path=str(path), mapped_atoms=MAPPED,
                conditioning_atoms=CONDITIONING, origin_atom=ORIGIN,
                axes_atoms=AXES, pca_whitening=True, n_maf_layers=N_LAYERS)


def _jax_map(path):
    kwargs = _map_kwargs(path)
    kwargs['temperature'] *= jax_units.ureg.kelvin
    bound = 3.0 * jnp.ones(N_MAPPED_DOFS)
    spline = JaxSpline.create(x0=-bound, xf=bound, n_bins=N_BINS,
                              fused='never')
    system = jax_traj.System(jax_topology.Topology(**_topology_kwargs()),
                             _frames())
    return jax_app.CartesianMAFMap(
        potential_energy_func=_JaxPotential(), system=system,
        flow_kwargs=dict(transformer=spline), **kwargs)


def _port_map(path):
    kwargs = _map_kwargs(path)
    kwargs['temperature'] *= ureg.kelvin
    bound = 3.0 * np.ones(N_MAPPED_DOFS)
    spline = NeuralSplineTransformer(-bound, bound, N_BINS, device=CPU,
                                     dtype=DTYPE)
    return CartesianMAFMap(
        potential_energy_func=_PortPotential(),
        system=System(Topology(**_topology_kwargs()), _frames()),
        flow_kwargs=dict(transformer=spline), device=CPU, dtype=DTYPE,
        **kwargs)


def _trainer(trainer_class):
    return trainer_class(save_dir=None, max_steps=N_STEPS, shuffle=True,
                         shuffle_seed=0)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Both maps, carried to the same weights, after 3 steps each."""
    path = tmp_path_factory.mktemp('parity')
    jax_map = _jax_map(path / 'jax')
    jax_map.setup()
    jax_map.flow = perturb(jax_map.flow, seed=1, scale=0.05)
    port_map = _port_map(path / 'port')
    port_map.setup()
    carry(jax_map.flow, port_map.flow)
    initial = {name: p.detach().clone()
               for name, p in port_map.flow.named_parameters()}

    jax_trainer = _trainer(jax_app.Trainer)
    jax_trainer.fit(jax_map)
    port_trainer = _trainer(Trainer)
    ops_spline.LAUNCHES.reset()
    port_trainer.fit(port_map)
    # The CPU runs the kernels' plain version, never a kernel.
    assert (ops_spline.LAUNCHES.forward, ops_spline.LAUNCHES.backward) == \
        (0, 0)
    return dict(jax_map=jax_map, port_map=port_map, jax_trainer=jax_trainer,
                port_trainer=port_trainer, initial=initial)


def test_same_stack_and_pca_fit(runs):
    # Both maps fitted their PCA on the same float32 frames in float64;
    # carry loaded every leaf, so compare the port's own fit with a
    # freshly set-up port map.
    fresh = _port_map(runs['port_map']._tfep_logger_dir_path + '_fresh')
    fresh.setup()
    pca = fresh.flow.flow.flow.flow
    state = jax_state(runs['jax_map'].flow)
    for name in ('mean', 'whitening_matrix', 'blackening_matrix',
                 'whitening_log_det_J'):
        close(getattr(pca, name), state[f'.flow.flow.flow.{name}'])
    assert runs['port_map'].kT == runs['jax_map'].kT
    assert runs['port_map'].n_nonfixed_dofs == runs['jax_map'].n_nonfixed_dofs


@pytest.mark.parametrize('step', range(N_STEPS))
def test_batch_order_and_logged_values(runs, step):
    jax_rows = runs['jax_map'].tfep_logger.read_train_tensors(step_idx=step)
    port_rows = runs['port_map'].tfep_logger.read_train_tensors(
        step_idx=step)
    assert sorted(port_rows) == sorted(jax_rows)
    for key in ('dataset_sample_index', 'trajectory_sample_index'):
        np.testing.assert_array_equal(port_rows[key], jax_rows[key])
    assert len(port_rows['potential']) == BATCH
    close(port_rows['potential'], jax_rows['potential'])
    close(port_rows['log_det_J'], jax_rows['log_det_J'])


def test_loss_history(runs):
    port, ref = runs['port_trainer'], runs['jax_trainer']
    assert port.global_step == ref.global_step == N_STEPS
    assert len(port.loss_history) == N_STEPS
    close(np.asarray(port.loss_history), np.asarray(ref.loss_history))


def test_final_weights(runs):
    trained = {torch_name(k): v
               for k, v in jax_state(runs['jax_map'].flow).items()}
    moved = False
    for name, param in runs['port_map'].flow.named_parameters():
        close(param, trained[name], GRAD_ATOL)
        moved |= not torch.equal(param, runs['initial'][name])
    assert moved
    for name, buf in runs['port_map'].flow.named_buffers():
        close(buf, trained[name], atol=0.0)


def test_run_evaluation(runs):
    # batch_size 48 leaves a short last batch (200 = 4 * 48 + 8): the JAX
    # map pads it to its compiled shape, the port runs it as it is.
    port = runs['port_map'].run_evaluation(N_STEPS, batch_size=48)
    ref = runs['jax_map'].run_evaluation(N_STEPS, batch_size=48)
    assert sorted(port) == sorted(ref)
    for key in ('dataset_sample_index', 'trajectory_sample_index'):
        np.testing.assert_array_equal(port[key], ref[key])
    close(port['potential'], ref['potential'], ATOL)
    close(port['log_det_J'], ref['log_det_J'], ATOL)
    logged = runs['port_map'].tfep_logger.read_eval_tensors(step_idx=N_STEPS)
    np.testing.assert_array_equal(logged['potential'], port['potential'])


class _JaxStub:
    """A flow of the JAX contract: y = 2x, log_det_J = sum(x), and a
    regularization term where asked."""

    def __init__(self, regularization):
        self.regularization = regularization

    def forward(self, x):
        out = (2.0 * x, jnp.sum(x, axis=-1))
        return out + (jnp.sum(x * x, axis=-1),) if self.regularization \
            else out


class _PortStub(torch.nn.Module):
    def __init__(self, regularization):
        super().__init__()
        self.regularization = regularization

    def forward(self, x):
        out = (2.0 * x, torch.sum(x, dim=-1))
        return out + (torch.sum(x * x, dim=-1),) if self.regularization \
            else out


@pytest.mark.parametrize('branch', ['plain', 'log_weights', 'bias',
                                    'ignore_nan', 'regularization'])
def test_training_step_branches(runs, branch):
    """training_step_fn's loss and aux on each of its branches: biased
    samples' log-weights (given, or a bias reduced by kT), NaN energies
    ignored, a regularization term."""
    rng = np.random.default_rng(7)
    batch = {'positions': rng.normal(size=(6, 3 * N_ATOMS)),
             'dataset_sample_index': np.arange(6),
             'trajectory_sample_index': np.arange(6) + 10}
    if branch == 'log_weights':
        batch['log_weights'] = rng.normal(size=6)
    if branch == 'bias':
        batch['bias'] = rng.normal(size=6)
    if branch == 'ignore_nan':
        batch['positions'][2, 0] = np.nan
    regularization = branch == 'regularization'
    jax_map, port_map = runs['jax_map'], runs['port_map']
    try:
        jax_map._ignore_nan = port_map._ignore_nan = branch == 'ignore_nan'
        loss_j, aux_j = jax_map.training_step_fn(
            _JaxStub(regularization),
            {k: jnp.asarray(v) for k, v in batch.items()})
        loss_t, aux_t = port_map.training_step_fn(
            _PortStub(regularization), port_map.batch_to_device(batch))
    finally:
        jax_map._ignore_nan = port_map._ignore_nan = False
    assert np.isfinite(float(loss_t))
    close(loss_t, loss_j)
    assert sorted(aux_t) == sorted(aux_j)
    for key in aux_j:
        close(aux_t[key], aux_j[key])
