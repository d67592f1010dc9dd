"""The port's engine-overlap trainer (``Trainer(engine_overlap=True)``).

Mirrors ``tests/app/test_pipeline.py`` on the port, in float64 on the CPU:
one pipelined step equals one plain step at 1e-10; three pipelined steps
equal a replay with delayed gradients (each update the exact gradient at
the parameters the engine saw); the epoch bookkeeping, the profiler
window on both paths, the loss channel, the overlap of a slow forward
with a slow engine, and the crash/resume invariant. Then what the port
adds: the engine makes one energy-and-forces call per step and nothing
else, ``prefetch`` is ignored on this path, NaN energies reach the loss's
``ignore_nan``, a run stopped mid-epoch (or by a crashed engine) and
resumed ends on the weights of the run that was not stopped, and the
parity case: the JAX and the port's ``CartesianMAFMap`` on carried
weights with a ``QuadraticEngine`` agree over 3 pipelined steps on the
batch order, logged work, losses and weights (1e-10 for values, 1e-9 for
weights, as in ``tests/test_torch_app_parity.py``).
"""

import copy
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfep_tpu.app as jax_app
import tfep_tpu.io.topology as jax_topology
import tfep_tpu.io.traj as jax_traj
import tfep_tpu.potentials as jax_potentials
import tfep_tpu.units as jax_units
from tfep_tpu.nn.transformers import NeuralSplineTransformer as JaxSpline
from tfep_tpu_torch.app import CartesianMAFMap, Trainer
from tfep_tpu_torch.app.trainer import default_optimizer
from tfep_tpu_torch.convert import torch_name
from tfep_tpu_torch.io.topology import Topology
from tfep_tpu_torch.io.traj import System
from tfep_tpu_torch.nn.transformers import NeuralSplineTransformer
from tfep_tpu_torch.potentials import EnginePotential
from tfep_tpu_torch.units import ureg

from test_torch_common import (
    ATOL, CPU, DTYPE, GRAD_ATOL, carry, close, jax_state, perturb,
)

ON_CPU = dict(device=CPU, dtype=DTYPE)


def quadratic_engine(base):
    """``QuadraticEngine`` of the JAX test on ``base`` (either package's
    ``EnginePotential``): u(x) = 0.5 |x|^2 (eV, angstrom) with exact
    forces, an optional host latency, every call recorded."""

    class QuadraticEngine(base):
        DEFAULT_ENERGY_UNIT = 'eV'
        DEFAULT_POSITIONS_UNIT = 'angstrom'
        ENGINE_ENERGY_UNIT = 'eV'
        ENGINE_POSITIONS_UNIT = 'angstrom'

        def __init__(self, sleep_s: float = 0.0, fail_samples=(),
                     crash_on_call=None, **kwargs):
            super().__init__(**kwargs)
            self.sleep_s = sleep_s
            self.fail_samples = fail_samples
            self.crash_on_call = crash_on_call
            self.calls = []

        def _compute_batch(self, positions, cell, compute_forces):
            if self.crash_on_call is not None and \
                    len(self.calls) + 1 == self.crash_on_call:
                raise RuntimeError('engine died mid-run')
            start = time.perf_counter()
            if self.sleep_s:
                time.sleep(self.sleep_s)
            energies = 0.5 * np.sum(positions ** 2, axis=-1)
            energies[list(self.fail_samples)] = np.nan
            forces = -positions if compute_forces else None
            self.calls.append((start, time.perf_counter(), compute_forces))
            return energies, forces

    return QuadraticEngine


QuadraticEngine = quadratic_engine(EnginePotential)


def make_system(n_frames=10, n_atoms=6, seed=0):
    """``tests/app/test_maps.py``'s system."""
    rng = np.random.default_rng(seed)
    topology = Topology(
        names=[f'C{i}' for i in range(n_atoms)],
        elements=['C'] * n_atoms,
        resnames=['MOL'] * (n_atoms // 2) + ['SOL'] * (n_atoms - n_atoms // 2),
        resids=[1] * (n_atoms // 2) + [2] * (n_atoms - n_atoms // 2),
    )
    return System(topology, rng.normal(0, 1, size=(n_frames, n_atoms, 3)))


def make_map(tmp_path, name, potential, map_class=CartesianMAFMap,
             n_frames=10, **kwargs):
    kwargs.setdefault('n_maf_layers', 2)
    return map_class(
        potential_energy_func=potential,
        temperature=300.0 * ureg.kelvin,
        system=make_system(n_frames=n_frames),
        batch_size=5,
        tfep_logger_dir_path=str(tmp_path / name),
        **ON_CPU, **kwargs)


def _weights(flow):
    return [p.detach().clone() for p in flow.parameters()]


def _assert_weights(actual, expected, atol):
    assert len(actual) == len(expected)
    for a, b in zip(actual, expected):
        close(a, b.numpy() if isinstance(b, torch.Tensor) else b, atol)


# --------------------------------------------------------------------------
# tests/app/test_pipeline.py
# --------------------------------------------------------------------------

def test_single_step_matches_standard_path(tmp_path):
    """One pipelined update == one standard update (exact surrogate
    gradient at the same parameters)."""
    flows = {}
    for overlap in (False, True):
        tfep_map = make_map(tmp_path, f'logs-{overlap}', QuadraticEngine())
        trainer = Trainer(save_dir=None, max_steps=1, shuffle=False,
                          engine_overlap=overlap)
        flows[overlap] = _weights(trainer.fit(tfep_map))
        assert trainer.global_step == 1
    _assert_weights(flows[True], flows[False], ATOL)


def test_multistep_delayed_gradient_contract(tmp_path):
    """Pipelined steps apply the exact gradient at the parameters the
    engine saw (one-step delay): theta_{k+1} = theta_k - opt(grad L(b_k,
    theta_{k-1})). Verified against a replay with the standard loss — a
    single-step test cannot catch a snapshot taken after the update."""
    n_steps = 3
    # 4 batches per epoch: no epoch-boundary drain within the first 3
    # steps, so the pipeline stays exactly one step deep throughout.
    tfep_map = make_map(tmp_path, 'logs-pipe', QuadraticEngine(),
                        n_frames=20)
    trainer = Trainer(save_dir=None, max_steps=n_steps, shuffle=False,
                      engine_overlap=True)
    pipelined = _weights(trainer.fit(tfep_map))

    replay_map = make_map(tmp_path, 'logs-replay', QuadraticEngine(),
                          n_frames=20)
    replay_map.setup()
    flow = replay_map.flow
    params = [p for p in flow.parameters() if p.requires_grad]
    optimizer = default_optimizer(params)
    history = [_weights(flow)]
    for k in range(n_steps):
        indices = np.arange(5 * k, 5 * k + 5)
        batch = replay_map.batch_to_device(
            replay_map.dataset.get_batch(indices))
        # The gradient at the parameters the engine saw: theta_{k-1}.
        snap = copy.deepcopy(flow)
        with torch.no_grad():
            for p, value in zip(snap.parameters(), history[max(0, k - 1)]):
                p.copy_(value)
        loss, _ = replay_map.training_step_fn(snap, batch)
        loss.backward()
        for p, s in zip(params, [q for q in snap.parameters()
                                 if q.requires_grad]):
            p.grad = torch.zeros_like(p) if s.grad is None else s.grad
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        history.append(_weights(flow))
    _assert_weights(pipelined, history[-1], GRAD_ATOL)
    # And not the undelayed run.
    plain = _weights(Trainer(save_dir=None, max_steps=n_steps, shuffle=False)
                     .fit(make_map(tmp_path, 'logs-plain', QuadraticEngine(),
                                   n_frames=20)))
    assert max(float((a - b).abs().max())
               for a, b in zip(pipelined, plain)) > 1e-8


def test_pipelined_epoch_bookkeeping(tmp_path):
    tfep_map = make_map(tmp_path, 'logs', QuadraticEngine())
    trainer = Trainer(save_dir=str(tmp_path / 'ckpt'), max_epochs=2,
                      shuffle=True, engine_overlap=True)
    trainer.fit(tfep_map)
    assert trainer.global_step == 4  # 10 frames / batch 5 * 2 epochs
    assert trainer.current_epoch == 2
    assert len(trainer.loss_history) == 4
    assert np.all(np.isfinite(trainer.loss_history))
    logged = tfep_map.tfep_logger.read_train_tensors(epoch_idx=1)
    assert set(logged['dataset_sample_index'].tolist()) == set(range(10))
    assert np.all(np.isfinite(logged['potential']))


@pytest.mark.parametrize('overlap', [False, True])
def test_profiler_hook_captures_trace(tmp_path, overlap):
    """Trainer(profile_dir=...) writes a trace and the step times of the
    configured window — on both training paths."""
    tfep_map = make_map(tmp_path, 'logs', QuadraticEngine())
    trainer = Trainer(save_dir=None, max_epochs=2, shuffle=False,
                      engine_overlap=overlap,
                      profile_dir=str(tmp_path / 'profile'),
                      profile_steps=(1, 3))
    trainer.fit(tfep_map)
    assert len(trainer.profiled_step_times) == 2
    assert all(t > 0 for t in trainer.profiled_step_times)
    assert os.path.isfile(tmp_path / 'profile' / 'trace.json')


def test_loss_history_on_standard_path(tmp_path, capsys):
    tfep_map = make_map(tmp_path, 'logs', QuadraticEngine())
    trainer = Trainer(save_dir=None, max_epochs=1, shuffle=False,
                      log_every_n_steps=1)
    trainer.fit(tfep_map)
    assert len(trainer.loss_history) == 2
    assert np.all(np.isfinite(trainer.loss_history))
    out = capsys.readouterr().out
    assert 'loss=' in out and 'epoch 0' in out


class SlowDeviceMap(CartesianMAFMap):
    """A forward with a controllable duration (on the CPU the forward runs
    on the main thread, which the sleep holds, as a heavy device graph
    holds the card)."""

    device_sleep_s = 0.0

    def forward_step_fn(self, flow, batch):
        if self.device_sleep_s:
            time.sleep(self.device_sleep_s)
        return super().forward_step_fn(flow, batch)


def test_overlap_hides_device_time_behind_engine(tmp_path):
    """Steady-state step time ~ max(engine, device), not engine + device,
    read from the engine's start-to-start intervals."""
    engine_s, device_s = 0.15, 0.10
    n_steps = 10
    potential = QuadraticEngine(sleep_s=engine_s)
    tfep_map = make_map(tmp_path, 'logs', potential,
                        map_class=SlowDeviceMap, n_frames=60)
    tfep_map.device_sleep_s = device_s
    trainer = Trainer(save_dir=None, max_steps=n_steps, shuffle=False,
                      engine_overlap=True)
    trainer.fit(tfep_map)

    # The engine genuinely ran once per step.
    assert len(potential.calls) == n_steps
    starts = np.array([start for start, _, _ in potential.calls])
    median = float(np.median(np.diff(starts[2:])))
    assert median < engine_s + 0.5 * device_s, (
        f'no overlap: median engine start-to-start {median:.3f}s vs '
        f'serial >= {engine_s + device_s:.3f}s')


class RecordingMap(CartesianMAFMap):
    visited = None

    def log_train_tensors(self, aux, epoch_idx, batch_idx):
        self.visited.append((epoch_idx,
                             np.asarray(aux['dataset_sample_index']).tolist()))
        super().log_train_tensors(aux, epoch_idx, batch_idx)


def test_pipelined_crash_resume_invariant(tmp_path):
    """The union of visited samples across an engine crash partitions each
    epoch with no repeats, and the resumed run picks up from the
    acknowledged global step."""
    visited = []
    ckpt = str(tmp_path / 'ckpt')

    # The engine dies evaluating its 4th batch: steps 1-3 are applied and
    # checkpointed (the pipeline runs the engine one batch ahead).
    tfep_map = make_map(tmp_path, 'logs1', QuadraticEngine(crash_on_call=4),
                        map_class=RecordingMap)
    tfep_map.visited = visited
    t1 = Trainer(save_dir=ckpt, max_epochs=3, shuffle=True,
                 engine_overlap=True)
    with pytest.raises(RuntimeError, match='engine died'):
        t1.fit(tfep_map)
    assert t1.global_step == 3      # 1.5 epochs at 2 batches/epoch

    tfep_map2 = make_map(tmp_path, 'logs1', QuadraticEngine(),
                         map_class=RecordingMap)
    tfep_map2.visited = visited
    t2 = Trainer(save_dir=ckpt, max_epochs=3, shuffle=True,
                 engine_overlap=True)
    t2.fit(tfep_map2, resume=True)
    assert t2.global_step == 6

    for epoch in range(3):
        flat = [i for e, b in visited if e == epoch for i in b]
        assert sorted(flat) == list(range(10)), (epoch, visited)
        logged = tfep_map2.tfep_logger.read_train_tensors(epoch_idx=epoch)
        assert set(logged['dataset_sample_index'].tolist()) == set(range(10))


# --------------------------------------------------------------------------
# What the port adds.
# --------------------------------------------------------------------------

def test_one_energy_and_forces_call_per_step(tmp_path):
    potential = QuadraticEngine()
    trainer = Trainer(save_dir=None, max_epochs=2, shuffle=True,
                      shuffle_seed=0, engine_overlap=True)
    trainer.fit(make_map(tmp_path, 'logs', potential))
    assert [forces for _, _, forces in potential.calls] == [True] * 4
    assert {name for name in trainer.host_seconds} >= {
        'forward', 'engine', 'engine_wait', 'step', 'log'}
    assert trainer.host_seconds['engine'][1] == 4


def test_prefetch_is_ignored(tmp_path):
    runs = []
    for prefetch in (False, True):
        trainer = Trainer(save_dir=None, max_epochs=2, shuffle=True,
                          shuffle_seed=3, engine_overlap=True,
                          prefetch=prefetch)
        runs.append((_weights(trainer.fit(make_map(
            tmp_path, f'logs{prefetch}', QuadraticEngine()))),
            trainer.loss_history))
    _assert_weights(runs[1][0], runs[0][0], 0.0)
    assert runs[1][1] == runs[0][1]


def test_nan_energy_reaches_ignore_nan(tmp_path):
    """A NaN energy poisons the sample in the surrogate and the reported
    loss alike; ``ignore_nan`` drops it from both."""
    tfep_map = make_map(tmp_path, 'logs', QuadraticEngine(fail_samples=[1]),
                        ignore_nan=True)
    trainer = Trainer(save_dir=None, max_steps=2, shuffle=False,
                      engine_overlap=True)
    flow = trainer.fit(tfep_map)
    assert np.all(np.isfinite(trainer.loss_history))
    assert all(torch.all(torch.isfinite(p)) for p in flow.parameters())
    rows = tfep_map.tfep_logger.read_train_tensors(step_idx=0)
    assert np.isnan(rows['potential'][1])
    assert np.sum(np.isnan(rows['potential'])) == 1


@pytest.mark.parametrize('stop', ['max_steps', 'engine_crash'])
def test_resume_mid_epoch_ends_on_uninterrupted_weights(tmp_path, stop):
    """The checkpoint keeps the snapshot of the next batch's forward (the
    parameters before the last update), so a run stopped mid-epoch and
    resumed applies the same delayed gradients as one that was not
    stopped."""
    def fit(name, potential, ckpt, resume=False, **kwargs):
        trainer = Trainer(save_dir=str(tmp_path / ckpt), shuffle=True,
                          shuffle_seed=0, engine_overlap=True, **kwargs)
        tfep_map = make_map(tmp_path, name, potential, n_frames=20)
        if stop == 'engine_crash' and potential.crash_on_call:
            with pytest.raises(RuntimeError, match='engine died'):
                trainer.fit(tfep_map)
        else:
            trainer.fit(tfep_map, resume=resume)
        return trainer, tfep_map

    whole, whole_map = fit('whole', QuadraticEngine(), 'a', max_epochs=2)
    if stop == 'max_steps':
        first, _ = fit('stopped', QuadraticEngine(), 'b', max_steps=3)
    else:
        first, _ = fit('stopped', QuadraticEngine(crash_on_call=4), 'b',
                       max_epochs=2)
    assert first.global_step == 3
    resumed, resumed_map = fit('stopped', QuadraticEngine(), 'b',
                               resume=True, max_epochs=2)
    assert resumed.global_step == whole.global_step == 8
    _assert_weights(_weights(resumed_map.flow), _weights(whole_map.flow),
                    0.0)
    assert resumed.loss_history == whole.loss_history[3:]


def test_checkpoint_at_epoch_boundary_keeps_no_snapshot(tmp_path):
    trainer = Trainer(save_dir=str(tmp_path / 'ck'), max_epochs=1,
                      shuffle=False, engine_overlap=True)
    trainer.fit(make_map(tmp_path, 'logs', QuadraticEngine()))
    state = torch.load(trainer.checkpoint_path, weights_only=False)
    assert 'pipeline_snapshot' not in state and state['global_step'] == 2

    trainer = Trainer(save_dir=str(tmp_path / 'mid'), max_steps=1,
                      shuffle=False, engine_overlap=True)
    tfep_map = make_map(tmp_path, 'logs2', QuadraticEngine())
    initial = {name: p.detach().clone() for name, p in
               (tfep_map.setup() or tfep_map.flow.named_parameters())}
    trainer.fit(tfep_map)
    state = torch.load(trainer.checkpoint_path, weights_only=False)
    assert sorted(state['pipeline_snapshot']) == sorted(initial)
    for name, value in state['pipeline_snapshot'].items():
        assert torch.equal(value, initial[name])


# --------------------------------------------------------------------------
# Parity with the JAX package's pipelined trainer.
# --------------------------------------------------------------------------

N_ATOMS, N_FRAMES, N_BINS, BATCH, N_STEPS = 10, 200, 4, 32, 3
MAPPED, CONDITIONING, ORIGIN, AXES = [1, 2, 4, 5, 7, 8], [0, 6], 0, [2, 5]
N_MAPPED_DOFS = 3 * len(MAPPED) - 3


def _frames():
    return np.random.default_rng(0).normal(size=(N_FRAMES, N_ATOMS, 3))


def _topology_kwargs():
    return dict(names=[f'C{i}' for i in range(N_ATOMS)],
                elements=['C'] * N_ATOMS, resnames=['MOL'] * N_ATOMS,
                resids=[1] * N_ATOMS)


def _parity_kwargs(path):
    return dict(batch_size=BATCH, tfep_logger_dir_path=str(path),
                mapped_atoms=MAPPED, conditioning_atoms=CONDITIONING,
                origin_atom=ORIGIN, axes_atoms=AXES, pca_whitening=True,
                n_maf_layers=2)


@pytest.fixture(scope='module')
def parity_runs(tmp_path_factory):
    path = tmp_path_factory.mktemp('pipeline_parity')
    bound = 3.0 * np.ones(N_MAPPED_DOFS)
    jax_map = jax_app.CartesianMAFMap(
        potential_energy_func=quadratic_engine(
            jax_potentials.EnginePotential)(),
        temperature=300.0 * jax_units.ureg.kelvin,
        system=jax_traj.System(jax_topology.Topology(**_topology_kwargs()),
                               _frames()),
        flow_kwargs=dict(transformer=JaxSpline.create(
            x0=-jnp.asarray(bound), xf=jnp.asarray(bound), n_bins=N_BINS,
            fused='never')),
        **_parity_kwargs(path / 'jax'))
    jax_map.setup()
    jax_map.flow = perturb(jax_map.flow, seed=1, scale=0.05)
    port_map = CartesianMAFMap(
        potential_energy_func=QuadraticEngine(),
        temperature=300.0 * ureg.kelvin,
        system=System(Topology(**_topology_kwargs()), _frames()),
        flow_kwargs=dict(transformer=NeuralSplineTransformer(
            -bound, bound, N_BINS, **ON_CPU)),
        **ON_CPU, **_parity_kwargs(path / 'port'))
    port_map.setup()
    carry(jax_map.flow, port_map.flow)

    runs = {}
    for name, app, tfep_map in (('jax', jax_app, jax_map),
                                ('port', None, port_map)):
        trainer_class = jax_app.Trainer if app else Trainer
        trainer = trainer_class(save_dir=None, max_steps=N_STEPS,
                                shuffle=True, shuffle_seed=0,
                                engine_overlap=True)
        trainer.fit(tfep_map)
        runs[name] = (tfep_map, trainer)
    return runs


@pytest.mark.parametrize('step', range(N_STEPS))
def test_parity_batch_order_and_logged_work(parity_runs, step):
    rows = {name: tfep_map.tfep_logger.read_train_tensors(step_idx=step)
            for name, (tfep_map, _) in parity_runs.items()}
    assert sorted(rows['port']) == sorted(rows['jax'])
    for key in ('dataset_sample_index', 'trajectory_sample_index'):
        np.testing.assert_array_equal(rows['port'][key], rows['jax'][key])
    assert len(rows['port']['potential']) == BATCH
    close(rows['port']['potential'], rows['jax']['potential'])
    close(rows['port']['log_det_J'], rows['jax']['log_det_J'])


def test_parity_losses_and_weights(parity_runs):
    jax_map, jax_trainer = parity_runs['jax']
    port_map, port_trainer = parity_runs['port']
    assert port_trainer.global_step == jax_trainer.global_step == N_STEPS
    close(np.asarray(port_trainer.loss_history),
          np.asarray(jax_trainer.loss_history))
    trained = {torch_name(k): v for k, v in jax_state(jax_map.flow).items()}
    for name, param in port_map.flow.named_parameters():
        close(param, trained[name], GRAD_ATOL)
    assert len(port_map._potential_energy_func.calls) == N_STEPS
