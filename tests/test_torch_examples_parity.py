"""The port's examples (``tfep_tpu_torch/examples/``) against the JAX
package's (``examples/``), in float64 on the CPU.

For each example:

- its frames equal the JAX example's draws bit for bit;
- its target potential equals the JAX example's at 1e-12, on tensors and
  on numpy arrays;
- its map, built by ``build_map`` with weights carried across from the
  JAX map (perturbed off the identity), takes the same first 3
  ``Trainer.fit`` steps with the example's optimizer as the JAX map with
  optax's: ``loss_history`` at 1e-10 and the final weights at 1e-9. The
  CNF map is fed the JAX map's Hutchinson probes, and its exact-trace
  evaluation is held against JAX's; the ensemble takes 3 steps of
  ``make_ensemble_train_step`` against the JAX step.

The optimizers of ``examples/_optim.py`` are held against optax over 20
updates at 1e-12.

The JAX examples that keep their run under ``if __name__ == '__main__'``
(triatomic, mixed, engine) are loaded as modules; the others run at
import, so the part of their source before the run (the seeds, the draws,
the potential and map classes) is executed on its own.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tfep_tpu.app as jax_app
import tfep_tpu.io.topology as jax_topology
import tfep_tpu.io.traj as jax_traj
import tfep_tpu.nn.ensemble as jax_ensemble
import tfep_tpu.parallel.strategies as jax_strategies
import tfep_tpu.units as jax_units
from tfep_tpu.nn.transformers import NeuralSplineTransformer as JaxSpline
from tfep_tpu_torch.app import Trainer
from tfep_tpu_torch.convert import (
    load_jax_ensemble_state, load_jax_state, torch_name,
)
from tfep_tpu_torch.examples import (
    _optim, cnf_tfep, engine_in_the_loop_tfep, ensemble_tfep,
    multimap_tfep_mixed, multimap_tfep_triatomic, solvated_preflow_tfep,
    toy_gaussian_tfep,
)
from tfep_tpu_torch.nn.ensemble import ensemble_map
from tfep_tpu_torch.parallel.strategies import SerialStrategy

from test_torch_common import (
    ATOL, CPU, GRAD_ATOL, close, jax_state, perturb, t,
)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / 'examples'
N_STEPS = 3
POTENTIAL_RTOL = 1e-12


@pytest.fixture(autouse=True)
def one_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def load_example(name):
    """A JAX example whose run is under ``__main__``, as a module."""
    spec = importlib.util.spec_from_file_location(
        f'jax_example_{name}', EXAMPLES / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def example_prefix(name, marker):
    """The namespace of a JAX example's source up to ``marker`` (the
    first line of its run)."""
    path = EXAMPLES / f'{name}.py'
    source = path.read_text()
    assert marker in source, (name, marker)
    namespace = {'__file__': str(path), '__name__': f'jax_example_{name}'}
    exec(compile(source.split(marker)[0], str(path), 'exec'), namespace)
    return namespace


def jax_trainer(optimizer, **kwargs):
    trainer = jax_app.Trainer(save_dir=None, max_steps=N_STEPS,
                              shuffle=True, shuffle_seed=0, **kwargs)
    trainer.optimizer = optimizer
    return trainer


def port_trainer(optimizer, **kwargs):
    return Trainer(save_dir=None, max_steps=N_STEPS, shuffle=True,
                   shuffle_seed=0, optimizer=optimizer, **kwargs)


def train_both(map_j, map_t, jax_optimizer, port_optimizer, seed=1,
               scale=0.05, skip=(), **trainer_kwargs):
    """Perturb the JAX map's flow, carry it into the port's, train both 3
    steps; returns the two trainers."""
    map_j.setup()
    map_j.flow = perturb(map_j.flow, seed=seed, scale=scale)
    map_t.setup()
    load_jax_state(map_t.flow, {
        k: v for k, v in jax_state(map_j.flow).items()
        if not any(k.endswith(suffix) for suffix in skip)})
    trainer_j = jax_trainer(jax_optimizer, **trainer_kwargs)
    trainer_j.fit(map_j)
    trainer_t = port_trainer(port_optimizer, **trainer_kwargs)
    trainer_t.fit(map_t)
    return trainer_j, trainer_t


def assert_same_training(map_j, map_t, trainer_j, trainer_t):
    assert trainer_t.global_step == trainer_j.global_step == N_STEPS
    close(np.asarray(trainer_t.loss_history),
          np.asarray(trainer_j.loss_history), ATOL)
    trained = {torch_name(k): v for k, v in jax_state(map_j.flow).items()}
    for name, param in map_t.flow.named_parameters():
        close(param, trained[name], GRAD_ATOL)


def assert_potential(port_fn, jax_fn, x):
    """Equal at 1e-12, relative to the values' size: the solvated
    example's quadratic form sums 42 x 42 products to values of about 40
    in another order than XLA's."""
    expected = np.asarray(jax_fn(jnp.asarray(x)))
    for actual in (port_fn(t(x)).numpy(), np.asarray(port_fn(x))):
        np.testing.assert_allclose(actual, expected, rtol=POTENTIAL_RTOL,
                                   atol=POTENTIAL_RTOL)


# =============================================================================
# The optimizers
# =============================================================================

OPTIMIZERS = {
    'adamw': (lambda: optax.adamw(5e-3), lambda: _optim.adamw(5e-3)),
    'cosine': (
        lambda: optax.adamw(optax.cosine_decay_schedule(3e-3, 8, alpha=0.05)),
        lambda: _optim.adamw(_optim.cosine_decay_schedule(3e-3, 8,
                                                          alpha=0.05))),
    'clipped_cosine': (
        lambda: optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
            optax.cosine_decay_schedule(2e-3, decay_steps=12))),
        lambda: _optim.adamw(_optim.cosine_decay_schedule(2e-3, 12),
                             max_grad_norm=1.0)),
}


@pytest.mark.parametrize('name', sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """20 updates of the same gradients (some above the clipping norm,
    some below), past the end of the schedules."""
    make_jax, make_port = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    start = [rng.normal(size=s) for s in ((3, 4), (5,))]
    params_j = [jnp.asarray(p) for p in start]
    transform = make_jax()
    state = transform.init(params_j)
    params_t = [torch.tensor(p, requires_grad=True) for p in start]
    optimizer = make_port()(params_t)
    for k in range(20):
        grads = [(0.1 if k % 2 else 3.0) * rng.normal(size=p.shape)
                 for p in start]
        updates, state = transform.update(
            [jnp.asarray(g) for g in grads], state, params_j)
        params_j = optax.apply_updates(params_j, updates)
        for p, g in zip(params_t, grads):
            p.grad = torch.tensor(g)
        optimizer.step()
    for p, expected in zip(params_t, params_j):
        close(p, expected, 1e-12)


def test_schedule_resumes_from_state_dict():
    """The update count is in the optimizer's state: a rebuilt optimizer
    loaded from it continues the schedule."""
    schedule = _optim.cosine_decay_schedule(1.0, 10, alpha=0.1)
    param = torch.zeros(2, requires_grad=True)
    optimizer = _optim.adamw(schedule)([param])
    for _ in range(4):
        param.grad = torch.ones(2)
        optimizer.step()
    rebuilt = _optim.adamw(schedule)([param])
    rebuilt.load_state_dict(optimizer.state_dict())
    param.grad = torch.ones(2)
    rebuilt.step()
    assert rebuilt.param_groups[0]['update_count'] == 5
    assert rebuilt.param_groups[0]['lr'] == schedule(4)


# =============================================================================
# toy_gaussian_tfep
# =============================================================================

@pytest.fixture(scope='module')
def toy_jax():
    return example_prefix('toy_gaussian_tfep',
                          "logdir = '/tmp/verify_tfep_logs'")


def test_toy_frames_and_potential(toy_jax):
    frames = toy_gaussian_tfep.data()
    np.testing.assert_array_equal(frames, toy_jax['positions'])
    assert toy_gaussian_tfep.DF_ANALYTIC == toy_jax['DF_ANALYTIC']
    assert_potential(toy_gaussian_tfep.GaussianPotential(),
                     toy_jax['GaussianPotential'](),
                     frames.reshape(len(frames), -1))


def test_toy_training(toy_jax, tmp_path):
    map_j = toy_jax['ToyMap'](
        potential_energy_func=toy_jax['GaussianPotential'](),
        temperature=300.0 * jax_units.ureg.kelvin, system=toy_jax['system'],
        batch_size=256, tfep_logger_dir_path=str(tmp_path / 'jax'))
    map_t = toy_gaussian_tfep.build_map(CPU, toy_gaussian_tfep.data(),
                                        logdir=str(tmp_path / 'port'))
    trainers = train_both(map_j, map_t, optax.adamw(5e-3),
                          toy_gaussian_tfep.optimizer())
    assert_same_training(map_j, map_t, *trainers)


# =============================================================================
# multimap_tfep_triatomic
# =============================================================================

@pytest.fixture(scope='module')
def triatomic_jax():
    return load_example('multimap_tfep_triatomic')


@pytest.fixture(scope='module')
def triatomic_frames():
    return multimap_tfep_triatomic.data()


def test_triatomic_frames_and_potential(triatomic_jax, triatomic_frames):
    frames = triatomic_frames
    np.testing.assert_array_equal(
        frames, triatomic_jax.sample_reference(triatomic_jax.N_SAMPLES))
    assert multimap_tfep_triatomic.analytic_df() == \
        triatomic_jax.analytic_df()
    x = frames.reshape(len(frames), -1)
    for r0 in (triatomic_jax.R0_A, triatomic_jax.R0_B):
        assert_potential(
            lambda x: multimap_tfep_triatomic.reduced_potential(x, r0),
            lambda x: triatomic_jax.reduced_potential(x, r0), x)
    assert_potential(multimap_tfep_triatomic.TargetPotential(),
                     triatomic_jax.TargetPotential(), x)


def test_triatomic_training(triatomic_jax, triatomic_frames, tmp_path):
    frames = triatomic_frames
    topology = jax_topology.Topology(
        names=['O1', 'O2', 'O3'], elements=['O', 'O', 'O'],
        bonds=[(0, 1), (1, 2)])
    map_j = jax_app.CartesianMAFMap(
        potential_energy_func=triatomic_jax.TargetPotential(),
        temperature=300.0 * jax_units.ureg.kelvin,
        system=jax_traj.System(topology, frames), batch_size=256,
        mapped_atoms=[0, 2], conditioning_atoms=[1], origin_atom=1,
        axes_atoms=[0, 2], n_maf_layers=4,
        flow_kwargs=dict(hidden_layers=[64, 64]),
        tfep_logger_dir_path=str(tmp_path / 'jax'))
    map_t = multimap_tfep_triatomic.build_map(CPU, frames,
                                              logdir=str(tmp_path / 'port'))
    trainers = train_both(map_j, map_t, optax.adamw(2e-3),
                          multimap_tfep_triatomic.optimizer())
    assert_same_training(map_j, map_t, *trainers)


# =============================================================================
# solvated_preflow_tfep
# =============================================================================

@pytest.fixture(scope='module')
def solvated_jax():
    return example_prefix('solvated_preflow_tfep',
                          '# -- The app-level map')


def test_solvated_frames_and_potential(solvated_jax):
    frames = solvated_preflow_tfep.data()
    for name in ('mean', 'cov_a', 'precision_b', 'positions',
                 'eval_positions', 'u_a_eval'):
        np.testing.assert_array_equal(frames[name], solvated_jax[name])
    assert solvated_preflow_tfep.DF_ANALYTIC == solvated_jax['DF_ANALYTIC']
    assert_potential(
        solvated_preflow_tfep.ContractedGaussianPotential(
            frames['mean'], frames['precision_b']),
        solvated_jax['ContractedGaussianPotential'](),
        frames['eval_positions'])


def test_solvated_training(solvated_jax, tmp_path):
    """Through the PCA and reference-frame pre-flows and the spline (on
    the CPU the transformer runs K1/K2's plain version)."""
    n_features = solvated_preflow_tfep.N_FLOW_FEATURES
    spline = JaxSpline.create(x0=-8.0 * jnp.ones(n_features),
                              xf=8.0 * jnp.ones(n_features), n_bins=8)
    map_j = jax_app.CartesianMAFMap(
        potential_energy_func=solvated_jax['ContractedGaussianPotential'](),
        temperature=300.0 * jax_units.ureg.kelvin,
        system=solvated_jax['system'], batch_size=512,
        mapped_atoms=list(range(1, 14)), conditioning_atoms=[0],
        origin_atom=0, axes_atoms=[1, 2], pca_whitening=True, n_maf_layers=2,
        flow_kwargs=dict(transformer=spline),
        tfep_logger_dir_path=str(tmp_path / 'jax'))
    map_t = solvated_preflow_tfep.build_map(
        CPU, solvated_preflow_tfep.data(), logdir=str(tmp_path / 'port'))
    # The weights are perturbed less than elsewhere: in whitened
    # coordinates a 0.05 perturbation gives losses of 1e4, where AdamW's
    # normalization of the near-zero gradients of a few weights magnifies
    # the order of the sums to 7e-8.
    trainers = train_both(
        map_j, map_t,
        optax.adamw(optax.cosine_decay_schedule(3e-3, 800, alpha=0.05)),
        solvated_preflow_tfep.optimizer(), scale=0.01)
    assert_same_training(map_j, map_t, *trainers)
    # The held-out frames through the evaluation channel.
    frames = solvated_preflow_tfep.data()['eval_positions'][:256]
    batch = {'positions': frames}
    close(map_t.forward(batch)['log_det_J'],
          map_j.forward({'positions': jnp.asarray(frames)})['log_det_J'])


# =============================================================================
# multimap_tfep_mixed
# =============================================================================

@pytest.fixture(scope='module')
def mixed_jax():
    return load_example('multimap_tfep_mixed')


@pytest.fixture(scope='module')
def mixed_frames():
    return multimap_tfep_mixed.data()


def test_mixed_frames_and_potential(mixed_jax, mixed_frames):
    frames = mixed_frames
    np.testing.assert_array_equal(
        frames, mixed_jax.sample_reference(mixed_jax.N_SAMPLES))
    assert multimap_tfep_mixed.analytic_df() == mixed_jax.analytic_df()
    x = frames.reshape(len(frames), -1)
    for r0 in (mixed_jax.R0_A, mixed_jax.R0_B):
        assert_potential(
            lambda x: multimap_tfep_mixed.reduced_potential(x, r0),
            lambda x: mixed_jax.reduced_potential(x, r0), x)
    # Each internal coordinate, the torsions' atan2 among them.
    pos = frames[:512]
    for port, ref in zip(multimap_tfep_mixed.internal_coords(t(pos)),
                         mixed_jax.internal_coords(jnp.asarray(pos))):
        close(port, ref, POTENTIAL_RTOL)


def test_mixed_training(mixed_jax, mixed_frames, tmp_path):
    frames = mixed_frames
    topology = jax_topology.Topology(
        names=['C1', 'C2', 'C3', 'C4', 'C5'], elements=['C'] * 5,
        bonds=[(0, 1), (1, 2), (2, 3), (3, 4)])
    map_j = jax_app.MixedMAFMap(
        potential_energy_func=mixed_jax.TargetPotential(),
        temperature=300.0 * jax_units.ureg.kelvin,
        system=jax_traj.System(topology, frames), batch_size=256,
        n_maf_layers=4, tfep_logger_dir_path=str(tmp_path / 'jax'))
    map_t = multimap_tfep_mixed.build_map(CPU, frames,
                                          logdir=str(tmp_path / 'port'))
    trainers = train_both(map_j, map_t, optax.adamw(2e-3),
                          multimap_tfep_mixed.optimizer())
    assert_same_training(map_j, map_t, *trainers)


# =============================================================================
# ensemble_tfep
# =============================================================================

@pytest.fixture(scope='module')
def ensemble_jax():
    return example_prefix('ensemble_tfep',
                          '# One map provides the dataset')


def test_ensemble_frames_and_potential(ensemble_jax):
    frames = toy_gaussian_tfep.data(ensemble_tfep.N_FRAMES)
    np.testing.assert_array_equal(frames, ensemble_jax['positions'])
    assert ensemble_tfep.K_MEMBERS == ensemble_jax['K_MEMBERS']
    assert ensemble_tfep.BATCH == ensemble_jax['BATCH']
    assert_potential(toy_gaussian_tfep.GaussianPotential(),
                     ensemble_jax['GaussianPotential'](),
                     frames.reshape(len(frames), -1))


def test_ensemble_training(ensemble_jax):
    """3 vmapped steps of the K members on the example's batches."""
    map_j = ensemble_jax['ToyMap'](
        potential_energy_func=ensemble_jax['GaussianPotential'](),
        temperature=300.0 * jax_units.ureg.kelvin,
        system=ensemble_jax['system'], batch_size=ensemble_tfep.BATCH,
        tfep_logger_dir_path=None)
    map_j.setup()
    members = []
    for k in range(ensemble_tfep.K_MEMBERS):
        map_j.seed = 100 * k
        members.append(map_j.configure_flow())
    stacked_j = perturb(jax_ensemble.stack_modules(members), seed=3,
                        scale=0.05)
    optimizer = optax.adamw(5e-3)
    opt_state = jax_ensemble.ensemble_init(optimizer, stacked_j)
    step_j = jax.jit(jax_ensemble.make_ensemble_train_step(
        lambda flow, batch: map_j.training_step_fn(flow, batch),
        optimizer, has_aux=True))

    positions = toy_gaussian_tfep.data()
    map_t, stacked = ensemble_tfep.build_ensemble(CPU, positions)
    load_jax_ensemble_state(stacked, jax_state(stacked_j))
    step = ensemble_tfep.make_step(map_t, stacked)

    # The JAX example's loop: the permutations of default_rng(7).
    shuffle_rng = np.random.default_rng(7)
    perm = shuffle_rng.permutation(ensemble_tfep.N_FRAMES)
    port_batches = ensemble_tfep.batches(map_t, ensemble_tfep.N_FRAMES, 1)
    for i in range(N_STEPS):
        idx = perm[i * ensemble_tfep.BATCH:(i + 1) * ensemble_tfep.BATCH]
        batch_j = {key: jnp.asarray(v) for key, v in
                   map_j.dataset.get_batch(idx.tolist()).items()}
        stacked_j, opt_state, losses_j, _ = step_j(stacked_j, opt_state,
                                                   batch_j)
        batch = next(port_batches)
        np.testing.assert_array_equal(batch['dataset_sample_index'], idx)
        losses, _ = step(stacked, batch)
        close(losses, losses_j)
    trained = {torch_name(k): v for k, v in jax_state(stacked_j).items()}
    for name, param in stacked.named_parameters():
        close(param, trained[name], GRAD_ATOL)

    # The per-member work of the trained members, through ensemble_map.
    x = positions.reshape(len(positions), -1)[:512]
    x_t = t(x)
    member_work = ensemble_tfep.member_work_fn(
        map_t, x_t, toy_gaussian_tfep.reduced_potential(x_t, 1.0))
    with torch.no_grad():
        works = ensemble_map(member_work, stacked)
    u_a = jnp.sum(jnp.asarray(x) ** 2, axis=-1) / 2

    def member_work_j(flow, x):
        out = map_j.forward_step_fn(flow, {'positions': x})
        return (ensemble_jax['GaussianPotential']()(out['positions'])
                - out['log_det_J'] - u_a)

    close(works, jax_ensemble.ensemble_map(member_work_j, stacked_j,
                                           jnp.asarray(x)))


# =============================================================================
# engine_in_the_loop_tfep
# =============================================================================

@pytest.fixture
def engine_jax(monkeypatch):
    module = load_example('engine_in_the_loop_tfep')
    monkeypatch.setattr(module, 'ENGINE_LATENCY_S', 0.0)
    monkeypatch.setattr(engine_in_the_loop_tfep, 'ENGINE_LATENCY_S', 0.0)
    return module


def test_engine_frames_and_potential(engine_jax):
    frames = engine_in_the_loop_tfep.data()
    np.testing.assert_array_equal(frames, engine_jax.rng.normal(
        0.0, engine_jax.SIGMA_A,
        size=(engine_jax.N_FRAMES, engine_jax.N_ATOMS, 3)))
    assert engine_in_the_loop_tfep.DF_ANALYTIC == engine_jax.DF_ANALYTIC
    x = frames.reshape(len(frames), -1)[:64]
    port = engine_in_the_loop_tfep.FakeQMPotential(
        parallelization_strategy=SerialStrategy())
    ref = engine_jax.FakeQMPotential(
        parallelization_strategy=jax_strategies.SerialStrategy())
    close(port(t(x)), np.asarray(ref(jnp.asarray(x))), POTENTIAL_RTOL)
    energies, forces = port.compute_energies_and_forces(x)
    energies_j, forces_j = ref.compute_energies_and_forces(x)
    close(energies, energies_j, POTENTIAL_RTOL)
    close(forces, forces_j, POTENTIAL_RTOL)
    for frame in x[:4]:
        e, f = engine_in_the_loop_tfep._fake_qm_single_point(
            frame.reshape(-1, 3), engine_jax.SIGMA_B, True)
        e_j, f_j = engine_jax._fake_qm_single_point(
            frame.reshape(-1, 3), engine_jax.SIGMA_B, True)
        assert e == e_j
        np.testing.assert_array_equal(f, f_j)


def test_engine_training(engine_jax, tmp_path):
    """3 pipelined steps (the engine overlapped with the flow), the
    engine on the host in both packages, kT = 1 eV."""
    frames = engine_in_the_loop_tfep.data()
    map_j = engine_jax.GaussianEngineMap(
        potential_energy_func=engine_jax.FakeQMPotential(
            parallelization_strategy=jax_strategies.SerialStrategy()),
        temperature=(engine_in_the_loop_tfep.TEMPERATURE_K
                     * jax_units.ureg.kelvin),
        system=jax_traj.System(jax_topology.Topology(names=['C'] * 2),
                               frames),
        batch_size=256, tfep_logger_dir_path=str(tmp_path / 'jax'))
    map_t = engine_in_the_loop_tfep.build_map(
        CPU, frames, engine_in_the_loop_tfep.FakeQMPotential(
            parallelization_strategy=SerialStrategy()),
        logdir=str(tmp_path / 'port'))
    assert map_t.kT == pytest.approx(1.0, abs=1e-12)
    trainers = train_both(map_j, map_t, optax.adamw(5e-3),
                          engine_in_the_loop_tfep.optimizer(),
                          engine_overlap=True)
    assert_same_training(map_j, map_t, *trainers)


# =============================================================================
# cnf_tfep
# =============================================================================

CNF_FRAMES, CNF_BATCH = 64, 16


@pytest.fixture(scope='module')
def cnf_jax():
    return example_prefix('cnf_tfep', "logdir = '/tmp/cnf_tfep_logs'")


def test_cnf_frames_and_potential(cnf_jax):
    frames = cnf_tfep.data()
    np.testing.assert_array_equal(frames, cnf_jax['positions'])
    assert cnf_tfep.DF_ANALYTIC == cnf_jax['DF_ANALYTIC']
    x = frames.reshape(len(frames), -1)
    for sigma in (cnf_jax['SIGMA_A'], cnf_jax['SIGMA_B']):
        assert_potential(lambda x: cnf_tfep.relative_potential(x, sigma),
                         lambda x: cnf_jax['relative_potential'](x, sigma),
                         x)


def _jax_probe(tfep_map, batch, x):
    """The probe the JAX map draws for a batch (its ``_run_flow``)."""
    idx = jnp.asarray(batch['dataset_sample_index']).astype(jnp.uint32)
    weights = 2 * jnp.arange(idx.shape[0], dtype=jnp.uint32) + 1
    key = jax.random.fold_in(jax.random.key(tfep_map.seed + 1),
                             jnp.sum(idx * weights))
    key = jax.random.fold_in(key, batch['global_step'])
    return np.asarray(jax.random.normal(key, (1, *x.shape), dtype=x.dtype))


def test_cnf_training_and_exact_evaluation(cnf_jax, tmp_path, monkeypatch):
    """3 Hutchinson steps with the clipped cosine AdamW, fed the JAX map's
    probes (the example's map on its first frames, a smaller batch), then
    the exact-trace evaluation of the trained flows under ``no_grad``."""
    frames = cnf_tfep.data()[:CNF_FRAMES]
    map_j = jax_app.ContinuousEGNNMap(
        potential_energy_func=cnf_jax['RelativeGaussianPotential'](),
        temperature=300.0 * jax_units.ureg.kelvin,
        system=jax_traj.System(jax_topology.Topology(names=['C'] * 4),
                               frames),
        batch_size=CNF_BATCH, tfep_logger_dir_path=str(tmp_path / 'jax'),
        r_cutoff=50.0, n_egnn_layers=2, node_feat_dim=16,
        distance_feat_dim=8, time_feat_dim=4, solver='rk4', n_steps=6,
        trace_estimator='hutchinson')
    map_t = cnf_tfep.build_map(CPU, frames, batch_size=CNF_BATCH,
                               logdir=str(tmp_path / 'port'))

    def run_flow(flow, batch, inverse):
        x = batch['positions']
        eps = _jax_probe(map_j, batch, x.detach().numpy())
        out = flow.integrate(x, t(eps), inverse=inverse)
        result = dict(positions=out[0], log_det_J=out[1])
        if len(out) > 2:
            result['regularization'] = out[2]
        return result

    monkeypatch.setattr(map_t, '_run_flow', run_flow)
    n_total = 30 * (CNF_FRAMES // CNF_BATCH)
    jax_optimizer = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(optax.cosine_decay_schedule(2e-3,
                                                decay_steps=n_total)))
    trainers = train_both(map_j, map_t, jax_optimizer,
                          cnf_tfep.optimizer(n_total), seed=2, scale=0.05,
                          skip=('.hutchinson_key',))
    trainer_j, trainer_t = trainers
    assert_same_training(map_j, map_t, *trainers)

    # The exact trace through a copy that shares the trained weights.
    x = frames.reshape(CNF_FRAMES, -1)[:24]
    y, ldj = cnf_tfep.exact_work_inputs(map_t.flow, t(x), chunk=16)
    assert map_t.flow.trace_estimator == 'hutchinson'
    y_j, ldj_j = map_j.flow.replace(trace_estimator='exact').forward(
        jnp.asarray(x))[:2]
    close(y, y_j)
    close(ldj, ldj_j)
    assert np.abs(ldj.numpy()).max() > 1e-3
