"""Distributed multimap TFEP: frames sharded over processes, engine in the loop.

The port of ``examples/distributed_tfep.py``: the production topology at
toy scale. The script launches itself as 2 processes of a
``torch.distributed`` gloo group, one rank each:

- every rank trains on its own shard of the trajectory frames
  (``host_frame_indices``, applied by ``Trainer(sharding=...)``), and one
  all-reduce per step averages the gradients and the loss, so every rank
  applies the global batch's update;
- the target potential is an external engine evaluated on each rank for
  its own frames only, overlapped with the flow's work
  (``Trainer(engine_overlap=True)``);
- per-sample work values go to per-rank TFEP loggers
  (``host_logger_dir``), keyed by trajectory sample index;
- after training, rank 0 merges every rank's logs over the estimation
  epochs (``all_hosts_work_values``) into the multimap free-energy
  estimate (arXiv:2302.07683) with a bootstrap confidence interval.

The system is the analytic Gaussian pair (reference state sigma_A, target
sigma_B), so the merged estimate is held against the exact answer.

Run on the CPU (``DIST_TFEP_DEVICE=cpu``) or, by default, on the card,
where both ranks share it (gloo: NCCL refuses two ranks on one card):

    DIST_TFEP_DEVICE=cpu python -m tfep_tpu_torch.examples.distributed_tfep

``DIST_TFEP_FRAMES``, ``DIST_TFEP_BATCH`` (rows per rank and step) and
``DIST_TFEP_EPOCHS`` size the run.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

N_PROCESSES = 2
N_FRAMES_GLOBAL = int(os.environ.get('DIST_TFEP_FRAMES', 2048))
LOCAL_BATCH = int(os.environ.get('DIST_TFEP_BATCH', 128))
N_EPOCHS = int(os.environ.get('DIST_TFEP_EPOCHS', 12))
DEVICE = os.environ.get('DIST_TFEP_DEVICE', 'cuda')
N_ESTIMATION_EPOCHS = max(1, N_EPOCHS - 4)
N_ATOMS = 2
SIGMA_A, SIGMA_B = 1.0, 0.7
ENGINE_LATENCY_S = 5e-4   # the fake engine's cost per frame
TIMEOUT_S = 900


def analytic_df():
    return -3 * N_ATOMS * np.log(SIGMA_B / SIGMA_A)


def reference_frames():
    """The reference ensemble's frames, the same on every rank."""
    rng = np.random.default_rng(7)
    return rng.normal(0.0, SIGMA_A, size=(N_FRAMES_GLOBAL, N_ATOMS, 3))


# ===========================================================================
# Worker (one rank)
# ===========================================================================

def worker(port: int, rank: int, workdir: str):
    import torch

    from tfep_tpu_torch.analysis import bootstrap, fep_estimator
    from tfep_tpu_torch.app import TFEPMapBase, Trainer
    from tfep_tpu_torch.io.topology import Topology
    from tfep_tpu_torch.io.traj import System
    from tfep_tpu_torch.nn.conditioners import generate_degrees
    from tfep_tpu_torch.nn.flows import MAF, SequentialFlow
    from tfep_tpu_torch.parallel.distributed import (
        all_hosts_work_values, host_logger_dir, initialize,
    )
    from tfep_tpu_torch.parallel.sharding import batch_sharding, make_mesh
    from tfep_tpu_torch.potentials.engine import EnginePotential
    from tfep_tpu_torch.units import ureg

    initialize(backend='gloo', init_method=f'tcp://127.0.0.1:{port}',
               world_size=N_PROCESSES, rank=rank, timeout=TIMEOUT_S)
    device = torch.device(DEVICE)
    positions = reference_frames()
    system = System(Topology(names=['C'] * N_ATOMS), positions)

    class FakeQMPotential(EnginePotential):
        """Gaussian 'QM' target evaluated frame by frame on this rank."""

        DEFAULT_ENERGY_UNIT = 'eV'
        DEFAULT_POSITIONS_UNIT = 'angstrom'
        ENGINE_ENERGY_UNIT = 'eV'
        ENGINE_POSITIONS_UNIT = 'angstrom'

        def _compute_batch(self, pos, cell, compute_forces):
            energies, forces = [], []
            for frame in pos:
                time.sleep(ENGINE_LATENCY_S)
                energies.append(np.sum(frame ** 2) / (2 * SIGMA_B ** 2))
                forces.append(-frame / SIGMA_B ** 2)
            return (np.asarray(energies),
                    np.stack(forces) if compute_forces else None)

    class GaussianMap(TFEPMapBase):
        def configure_flow(self):
            n_dofs = self.dataset.n_atoms * 3
            return SequentialFlow.create(*[MAF.create(
                torch.Generator().manual_seed(self.seed + i),
                generate_degrees(n_dofs, order=order), device=self.device,
                dtype=self.dtype)
                for i, order in enumerate(('ascending', 'descending'))],
                device=self.device)

    # kT == 1 eV: reduced potentials equal the engine's energies.
    tfep_map = GaussianMap(
        potential_energy_func=FakeQMPotential(),
        temperature=11604.518121550082 * ureg.kelvin, system=system,
        batch_size=LOCAL_BATCH,   # rows per rank: global batch 2x this
        tfep_logger_dir_path=host_logger_dir(workdir, rank), device=device)

    trainer = Trainer(
        save_dir=None, max_epochs=N_EPOCHS, shuffle=False,
        engine_overlap=True,
        sharding=batch_sharding(make_mesh(device=device)),
        optimizer=lambda p: torch.optim.AdamW(p, lr=5e-3,
                                              weight_decay=1e-4))
    t0 = time.perf_counter()
    trainer.fit(tfep_map)
    wall = time.perf_counter() - t0

    result = {'rank': rank, 'global_step': trainer.global_step,
              'wall_s': round(wall, 2),
              'loss_history': trainer.loss_history}

    # Rank 0 merges every rank's work values into the multimap estimate
    # once all ranks have flushed their logs.
    torch.distributed.barrier()
    if rank == 0:
        u_a_all = np.sum(positions.reshape(N_FRAMES_GLOBAL, -1) ** 2,
                         axis=-1) / (2 * SIGMA_A ** 2)
        work = []
        for epoch in range(N_EPOCHS - N_ESTIMATION_EPOCHS, N_EPOCHS):
            merged = all_hosts_work_values(
                workdir, epoch_idx=epoch, n_hosts=N_PROCESSES,
                names=('potential', 'log_det_J', 'trajectory_sample_index'))
            u_a = u_a_all[merged['trajectory_sample_index'].astype(int)]
            work.append(merged['potential'] - merged['log_det_J'] - u_a)
        work = torch.as_tensor(np.concatenate(work), device=device)
        boot = bootstrap(
            work, lambda d, vectorized=False, weights=None:
                fep_estimator(d, weights=weights, vectorized=vectorized),
            n_resamples=500, seed=1)
        result.update(
            df_multimap=float(fep_estimator(work)),
            ci_low=float(boot['confidence_interval']['low']),
            ci_high=float(boot['confidence_interval']['high']),
            n_work_values=int(work.numel()), df_analytic=analytic_df())

    with open(os.path.join(workdir, f'result-{rank}.json'), 'w') as f:
        json.dump(result, f)
    torch.distributed.destroy_process_group()
    print(f'rank {rank} done in {wall:.1f}s', flush=True)


# ===========================================================================
# Launcher
# ===========================================================================

def main(workdir=None):
    # Every rank must run the same number of equal batches per epoch.
    assert N_FRAMES_GLOBAL % N_PROCESSES == 0, \
        'DIST_TFEP_FRAMES must be divisible by the number of processes.'

    workdir = workdir or tempfile.mkdtemp(prefix='dist_tfep_')
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]

    # Workers log to files (reading pipes one after the other could stall
    # the group when a worker fills its pipe).
    logs = [os.path.join(workdir, f'worker-{rank}.log')
            for rank in range(N_PROCESSES)]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
    procs = []
    for rank, log in enumerate(logs):
        with open(log, 'w') as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), '--worker',
                 str(port), str(rank), workdir],
                env=env, stdout=out, stderr=subprocess.STDOUT))
    try:
        for proc in procs:
            proc.wait(timeout=TIMEOUT_S)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        if proc.returncode != 0:
            with open(log) as f:
                raise RuntimeError(f'worker failed:\n{f.read()[-4000:]}')

    results = {}
    for rank in range(N_PROCESSES):
        with open(os.path.join(workdir, f'result-{rank}.json')) as f:
            results[rank] = json.load(f)

    # The loss is the global batch's, averaged over the ranks: the same
    # on every rank.
    assert results[0]['loss_history'] == results[1]['loss_history']

    r0 = results[0]
    print(f"steps: {r0['global_step']} "
          f"(walls: {[results[r]['wall_s'] for r in range(N_PROCESSES)]}s)")
    print(f"work values merged across ranks+epochs: {r0['n_work_values']}")
    print(f"analytic df      = {r0['df_analytic']:.4f} kT")
    print(f"multimap TFEP df = {r0['df_multimap']:.4f} kT   "
          f"CI=[{r0['ci_low']:.4f}, {r0['ci_high']:.4f}]")
    assert r0['ci_low'] - 0.15 <= r0['df_analytic'] <= r0['ci_high'] + 0.15, \
        'distributed multimap TFEP estimate misses the analytic value'
    print('DISTRIBUTED TFEP OK')
    return results


if __name__ == '__main__':
    if len(sys.argv) > 1 and sys.argv[1] == '--worker':
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
