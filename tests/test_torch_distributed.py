"""The port's data parallelism over real processes, against JAX.

The port's mirror of ``tests/parallel/test_distributed.py`` and
``tests/parallel/test_multihost.py``. Two processes join a gloo process
group on the CPU (``tests/torch_distributed_worker.py``, which imports no
JAX) and train the map of ``tests/test_torch_app_parity.py`` in float64
through ``Trainer(sharding=batch_sharding(make_mesh()))``, each on its
contiguous half of the frames, from the JAX map's weights. The JAX
package's ``Trainer`` steps the same weights on the same global batches
(both ranks' local batches concatenated): losses, logged values and
final weights must agree to 1e-10, the loss history must be identical on
both ranks, and the ranks' logs must merge to every frame once. Then a
stopped and resumed run, a sharded ``ContinuousEGNNMap``, the collectives
and placement helpers, and the host-side helpers without processes.
"""

import os
import socket
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfep_tpu.app as jax_app
import tfep_tpu.io.dataset as jax_dataset
import tfep_tpu.io.log as jax_log
import tfep_tpu.io.topology as jax_topology
import tfep_tpu.io.traj as jax_traj
import tfep_tpu.units as jax_units
from tfep_tpu.nn.transformers import NeuralSplineTransformer as JaxSpline
from tfep_tpu_torch.app import Trainer
from tfep_tpu_torch.convert import torch_name
from tfep_tpu_torch.io.log import TFEPLogger
from tfep_tpu_torch.parallel import distributed as D
from tfep_tpu_torch.parallel.sharding import make_mesh

import torch_distributed_worker as W
from test_torch_common import ATOL, close, jax_state, perturb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = W.N_EPOCHS * W.N_FRAMES // (W.N_RANKS * W.LOCAL_BATCH)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_workers(script, n_processes, workdir, timeout=240):
    """Run ``n_processes`` ranks of ``tests/<script>`` on a free port;
    each writes its output to ``workdir/rank-<r>.log``."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1')
    logs = [os.path.join(workdir, f'rank-{r}.log')
            for r in range(n_processes)]
    procs = []
    for rank, log in enumerate(logs):
        with open(log, 'w') as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, 'tests', script),
                 str(port), str(rank), str(n_processes), str(workdir)],
                env=env, stdout=out, stderr=subprocess.STDOUT))
    try:
        for proc in procs:
            proc.wait(timeout=timeout)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        with open(log) as f:
            assert proc.returncode == 0, f.read()[-4000:]
    return [torch.load(os.path.join(workdir, f'result-{r}.pt'),
                       weights_only=False) for r in range(n_processes)]


class _JaxPotential:
    energy_unit = jax_units.ureg.kilocalorie_per_mole

    def __call__(self, x, cell=None):
        return jnp.sum(x, axis=-1)


class _GlobalBatches(jax_app.CartesianMAFMap):
    """The JAX map fed the global batches: the frames in the order in
    which the two ranks' local batches concatenate."""

    def create_dataset(self):
        return jax_dataset.Subset(super().create_dataset(), W.global_order())


def jax_map(logs):
    kwargs = W.map_kwargs(logs)
    kwargs['batch_size'] = W.N_RANKS * W.LOCAL_BATCH
    bound = 3.0 * jnp.ones(W.N_MAPPED_DOFS)
    spline = JaxSpline.create(x0=-bound, xf=bound, n_bins=W.N_BINS,
                              fused='never')
    system = jax_traj.System(
        jax_topology.Topology(**W.topology_kwargs()), W.frames())
    return _GlobalBatches(
        potential_energy_func=_JaxPotential(), system=system,
        temperature=300.0 * jax_units.ureg.kelvin,
        flow_kwargs=dict(transformer=spline), **kwargs)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp('distributed')
    reference = jax_map(str(workdir / 'jax-logs'))
    reference.setup()
    reference.flow = perturb(reference.flow, seed=1, scale=0.05)
    torch.save(jax_state(reference.flow), workdir / 'jax_state.pt')
    trainer = jax_app.Trainer(save_dir=None, max_epochs=W.N_EPOCHS,
                              shuffle=False)
    trainer.fit(reference)
    results = run_workers('torch_distributed_worker.py', W.N_RANKS, workdir)
    return dict(jax_map=reference, jax_trainer=trainer, results=results)


def test_sharded_fit_matches_jax_on_global_batches(runs):
    reference = runs['jax_trainer']
    trained = {torch_name(k): v
               for k, v in jax_state(runs['jax_map'].flow).items()}
    for result in runs['results']:
        assert result['global_step'] == reference.global_step == N_STEPS
        # One all-reduce of the gradients and the loss per step.
        assert result['allreduce_calls'] == N_STEPS
        close(np.asarray(result['losses']),
              np.asarray(reference.loss_history), ATOL)
        for name, value in result['weights'].items():
            close(value, trained[name], ATOL)


def test_loss_history_identical_on_every_rank(runs):
    first, second = runs['results']
    assert first['losses'] == second['losses']
    assert all(np.isfinite(first['losses']))
    for name, value in first['weights'].items():
        np.testing.assert_array_equal(value, second['weights'][name])


@pytest.mark.parametrize('epoch', range(W.N_EPOCHS))
def test_rank_logs_merge_to_every_frame_once(runs, epoch):
    merged = runs['results'][0]['merged'][epoch]
    frames = merged['trajectory_sample_index'].astype(int)
    assert sorted(frames) == list(range(W.N_FRAMES))
    # The Trainer keeps the dataset's own sample indices.
    np.testing.assert_array_equal(merged['dataset_sample_index'], frames)
    # Each frame's logged values equal JAX's for that frame.
    logged = runs['jax_map'].tfep_logger.read_train_tensors(epoch_idx=epoch)
    order = np.argsort(logged['trajectory_sample_index'])
    mine = np.argsort(frames)
    close(merged['potential'][mine], logged['potential'][order], ATOL)
    close(merged['log_det_J'][mine], logged['log_det_J'][order], ATOL)


def test_sharded_crash_resume_visits_each_frame_once(runs):
    seen = []
    for result in runs['results']:
        stopped, resumed = result['resume']
        assert stopped['global_step'] == 2
        assert resumed['global_step'] == W.N_FRAMES // (
            W.N_RANKS * W.LOCAL_BATCH)
        seen += [i for run in (stopped, resumed) for batch in run['visited']
                 for i in batch]
    assert len(seen) == W.N_FRAMES, 'crash+resume must visit each frame once'
    assert set(seen) == set(range(W.N_FRAMES))


def test_sharded_continuous_egnn_map_fit(runs):
    first, second = (r['cnf'] for r in runs['results'])
    steps = W.CNF_FRAMES // (W.N_RANKS * W.CNF_BATCH)
    assert first['global_step'] == second['global_step'] == steps
    assert first['losses'] == second['losses']
    assert np.all(np.isfinite(first['losses']))
    merged = first['merged']
    assert sorted(merged['dataset_sample_index'].tolist()) == list(
        range(W.CNF_FRAMES))
    assert np.all(np.isfinite(merged['potential']))
    # The probe seed folds in the batch's global sample indices: the
    # ranks draw different probes.
    seeds = first['probe_seeds']
    assert seeds == second['probe_seeds'] and seeds[0] != seeds[1]


def test_collectives_and_placement(runs):
    for rank, result in enumerate(runs['results']):
        helpers = result['helpers']
        rows = np.concatenate([np.arange(6.0).reshape(3, 2) + 10 * r
                               for r in range(W.N_RANKS)])
        np.testing.assert_array_equal(helpers['global_rows'], rows)
        batch = helpers['global_batch']
        np.testing.assert_array_equal(batch['x'], rows)
        np.testing.assert_array_equal(batch['i'], np.arange(6))
        assert batch['i'].dtype == np.int64
        np.testing.assert_array_equal(
            batch['b'], [True, False, False, True, False, True])
        np.testing.assert_array_equal(helpers['shard'],
                                      np.arange(4) + 4 * rank)
        assert helpers['mesh_shape'] == (W.N_RANKS,)
        assert helpers['axes'] == ('dp',)
        assert helpers['process'] == (True, rank, W.N_RANKS)
        # Replicated from rank 0.
        np.testing.assert_array_equal(helpers['replicated'],
                                      np.zeros((2, 3)))


# --------------------------------------------------------------------------
# Host-side helpers, in this process.
# --------------------------------------------------------------------------

@pytest.mark.parametrize('n_frames,n_hosts', [(16, 4), (17, 4), (1, 1)])
def test_host_frame_indices_partition(n_frames, n_hosts):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        shards = [D.host_frame_indices(n_frames, h, n_hosts)
                  for h in range(n_hosts)]
    per_host = n_frames // n_hosts
    np.testing.assert_array_equal(np.concatenate(shards),
                                  np.arange(per_host * n_hosts))
    assert {len(s) for s in shards} == {per_host}


def test_host_frame_indices_remainder_warns_and_drops():
    with pytest.warns(UserWarning, match='dropping the trailing 2'):
        sizes = [len(D.host_frame_indices(10, h, 4)) for h in range(4)]
    assert sizes == [2, 2, 2, 2]
    with pytest.raises(ValueError, match='at least one frame'):
        D.host_frame_indices(3, 0, 4)


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_all_hosts_work_values_roundtrip(tmp_path, writer):
    """Logs of either package's ``TFEPLogger`` merge alike."""
    logger_class = TFEPLogger if writer == 'port' else jax_log.TFEPLogger
    base = str(tmp_path / 'logs')
    n_frames, n_hosts = 9, 3
    for host in range(n_hosts):
        frames = D.host_frame_indices(n_frames, host, n_hosts)
        logger = logger_class(save_dir_path=D.host_logger_dir(base, host),
                              batch_size=len(frames),
                              n_samples_per_epoch=len(frames))
        logger.save_train_tensors({
            'dataset_sample_index': frames, 'potential': frames * 1.5,
            'log_det_J': np.zeros(len(frames))}, epoch_idx=0, batch_idx=0)
    merged = D.all_hosts_work_values(base, epoch_idx=0)
    np.testing.assert_array_equal(merged['dataset_sample_index'],
                                  np.arange(n_frames))
    np.testing.assert_allclose(merged['potential'], np.arange(n_frames) * 1.5)


def test_single_process_runtime():
    """Without a process group: one process of rank 0, and
    ``initialize`` outside a launch is a no-op."""
    assert not torch.distributed.is_initialized()
    D.initialize(world_size=1, rank=0, device='cpu')
    env = {k: v for k, v in os.environ.items() if k != 'WORLD_SIZE'}
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(os, 'environ', env)
        D.initialize(device='cpu')
    assert not torch.distributed.is_initialized()
    assert (D.is_distributed(), D.process_index(), D.process_count()) == (
        False, 0, 1)
    rows = np.arange(4)
    np.testing.assert_array_equal(D.global_rows_from_local(rows), rows)
    assert D.host_logger_dir('/logs') == os.path.join('/logs', 'host-0')


@pytest.mark.parametrize('kwargs', [dict(world_size=2),
                                    dict(world_size=2, rank=2),
                                    dict(rank=0)])
def test_initialize_misconfiguration_raises(kwargs):
    with pytest.raises(ValueError):
        D.initialize(device='cpu', **kwargs)
    assert not torch.distributed.is_initialized()


def test_make_mesh_model_axis_must_divide():
    with pytest.raises(ValueError, match='must divide'):
        make_mesh(6, model_axis_size=4, device='cpu')
    with pytest.raises(ValueError, match='spans every process'):
        make_mesh(2, device='cpu')
    assert not torch.distributed.is_initialized()


def test_trainer_takes_only_a_batch_sharding():
    with pytest.raises(TypeError, match='batch_sharding'):
        Trainer(max_steps=1, sharding=object())
