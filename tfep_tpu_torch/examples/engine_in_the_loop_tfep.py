"""Engine-in-the-loop TFEP: ``EnginePotential`` + process pool + overlap.

The port of ``examples/engine_in_the_loop_tfep.py``: ``Trainer.fit`` with
the target potential evaluated by an external engine on the host
(per-frame single points fanned out over a process pool,
``ProcessPoolStrategy``), bridged into the training step and overlapped
with the card's work (``Trainer(engine_overlap=True)``).

When ``tblite`` is importable the engine is a real GFN2-xTB water dimer;
otherwise a fake QM engine (numpy on the host, with a latency per frame)
stands in. Either way the pipeline is the same: the engine sees one frame
per task. With the fake engine the system is the analytic Gaussian pair,
so the TFEP estimate is held against the exact answer.

The pool's processes are spawned, not forked: a process forked after CUDA
has started in the parent cannot use it. The fake engine's latency per
frame (2 ms) can be set with ``ENGINE_TFEP_LATENCY_S``; it changes no
number, only the wall time.

Everything runs in float64, as the JAX example does, so its tolerances
carry over. Run on the card, or on the CPU with ``--device cpu``:

    python -m tfep_tpu_torch.examples.engine_in_the_loop_tfep [--device cpu]
"""

from __future__ import annotations

import multiprocessing
import os
import time

import numpy as np
import torch

from tfep_tpu_torch.app import TFEPMapBase, Trainer
from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.examples._common import (
    estimate, make_workdir, parse_args,
)
from tfep_tpu_torch.examples._optim import adamw
from tfep_tpu_torch.io.topology import Topology
from tfep_tpu_torch.io.traj import System
from tfep_tpu_torch.nn.conditioners import generate_degrees
from tfep_tpu_torch.nn.flows import MAF, SequentialFlow
from tfep_tpu_torch.parallel.strategies import ProcessPoolStrategy
from tfep_tpu_torch.potentials.engine import EnginePotential
from tfep_tpu_torch.units import ureg

N_FRAMES, N_ATOMS = 2048, 2
BATCH_SIZE, N_EPOCHS = 256, 25
N_WORKERS = 4
SIGMA_A, SIGMA_B = 1.0, 0.7
DF_ANALYTIC = -3 * N_ATOMS * np.log(SIGMA_B / SIGMA_A)
# Per-frame single-point cost of the fake engine (read again by each of
# the pool's spawned processes).
ENGINE_LATENCY_S = float(os.environ.get('ENGINE_TFEP_LATENCY_S', 0.002))
# kT == 1 eV exactly (the engine's energy unit): reduced potentials equal
# the raw engine energies.
TEMPERATURE_K = 11604.518121550082
LEARNING_RATE = 5e-3
DTYPE = torch.float64


def data(n_frames: int = N_FRAMES) -> np.ndarray:
    """The frames of state A, ``(n_frames, N_ATOMS, 3)``: the JAX
    example's draws."""
    rng = np.random.default_rng(5)
    return rng.normal(0.0, SIGMA_A, size=(n_frames, N_ATOMS, 3))


def _fake_qm_single_point(positions, sigma_b, compute_forces):
    """One frame's 'QM' single point (module-level: it pickles into the
    pool's processes). positions: (n_atoms, 3) angstrom; energy in eV."""
    time.sleep(ENGINE_LATENCY_S)
    energy = float(np.sum(positions ** 2) / (2 * sigma_b ** 2))
    forces = -positions / sigma_b ** 2 if compute_forces else None
    return energy, forces


class FakeQMPotential(EnginePotential):
    """Gaussian 'QM' engine evaluated frame by frame on the host."""

    DEFAULT_ENERGY_UNIT = 'eV'
    DEFAULT_POSITIONS_UNIT = 'angstrom'
    ENGINE_ENERGY_UNIT = 'eV'
    ENGINE_POSITIONS_UNIT = 'angstrom'

    def _compute_batch(self, positions, cell, compute_forces):
        task_args = [(positions[i].reshape(-1, 3), SIGMA_B, compute_forces)
                     for i in range(positions.shape[0])]
        results = self.parallelization_strategy.run(
            _fake_qm_single_point, task_args)
        energies = np.asarray([r[0] for r in results])
        forces = (np.stack([r[1].reshape(-1) for r in results])
                  if compute_forces else None)
        return energies, forces


def make_potential(pool):
    """Real tblite engine when available, fake QM otherwise."""
    try:
        from tfep_tpu_torch.potentials.tblite import (
            TBLITE_INSTALLED, TBLitePotential,
        )
    except ImportError:
        TBLITE_INSTALLED = False
    strategy = ProcessPoolStrategy(pool)
    if TBLITE_INSTALLED:
        return TBLitePotential(method='GFN2-xTB',
                               numbers=np.array([8, 1] * (N_ATOMS // 2)),
                               parallelization_strategy=strategy)
    return FakeQMPotential(parallelization_strategy=strategy)


class GaussianEngineMap(TFEPMapBase):
    """Two affine MAF layers, in ascending and descending order."""

    def configure_flow(self):
        n_dofs = self.dataset.n_atoms * 3
        return SequentialFlow.create(*[
            MAF.create(torch.Generator().manual_seed(self.seed + i),
                       generate_degrees(n_dofs, order=order),
                       device=self.device, dtype=self.dtype)
            for i, order in enumerate(('ascending', 'descending'))],
            device=self.device)


def build_map(device, positions, potential,
              logdir=None) -> GaussianEngineMap:
    """The example's map (float64 on ``device``) against ``potential``."""
    return GaussianEngineMap(
        potential_energy_func=potential,
        temperature=TEMPERATURE_K * ureg.kelvin,
        system=System(Topology(names=['C'] * N_ATOMS), positions),
        batch_size=BATCH_SIZE, tfep_logger_dir_path=logdir,
        device=device, dtype=DTYPE)


def optimizer():
    """``optax.adamw(5e-3)``."""
    return adamw(LEARNING_RATE)


def run(device=None, workdir=None, n_frames: int = N_FRAMES,
        n_epochs: int = N_EPOCHS, n_resamples: int = 500) -> dict:
    """Train against the engine, overlapped, and estimate from the last
    epoch's logged work values."""
    device = resolve_device(device)
    workdir = make_workdir(workdir, 'engine_in_the_loop_tfep')
    positions = data(n_frames)

    with multiprocessing.get_context('spawn').Pool(N_WORKERS) as pool:
        tfep_map = build_map(device, positions, make_potential(pool),
                             logdir=os.path.join(workdir, 'logs'))
        trainer = Trainer(save_dir=None, max_epochs=n_epochs, shuffle=True,
                          engine_overlap=True, log_every_n_steps=80,
                          optimizer=optimizer())
        start = time.perf_counter()
        trainer.fit(tfep_map)
        wall = time.perf_counter() - start

    logged = tfep_map.tfep_logger.read_train_tensors(
        epoch_idx=trainer.current_epoch - 1)
    idx = logged['dataset_sample_index'].astype(int)
    u_a = np.sum(positions.reshape(n_frames, -1)[idx] ** 2,
                 axis=-1) / (2 * SIGMA_A ** 2)
    work = logged['potential'] - logged['log_det_J'] - u_a
    df, low, high = estimate(work, device, n_resamples)
    return dict(df=df, ci=(low, high), df_analytic=DF_ANALYTIC, margin=0.15,
                steps=trainer.global_step, wall_s=wall,
                engine_busy_s=(trainer.global_step * BATCH_SIZE
                               * ENGINE_LATENCY_S / N_WORKERS),
                host_seconds=trainer.host_seconds, workdir=workdir)


def check(results: dict, statistical: bool = True):
    """The JAX example's assert (the interval against the analytic df,
    with its margin), which depends on the run's size."""
    if statistical:
        low, high = results['ci']
        assert low - 0.15 <= DF_ANALYTIC <= high + 0.15, (
            f"TFEP estimate {results['df']} (CI [{low},{high}]) misses "
            f'analytic {DF_ANALYTIC}')


def main(argv=None):
    args = parse_args(argv, __doc__)
    results = run(args.device, args.workdir)
    print(f"trained steps: {results['steps']} in {results['wall_s']:.1f}s "
          f"(engine busy ~{results['engine_busy_s']:.1f}s across the pool)")
    low, high = results['ci']
    print(f'analytic df  = {DF_ANALYTIC:.4f} kT')
    print(f"TFEP df      = {results['df']:.4f} kT   "
          f'CI=[{low:.4f}, {high:.4f}]')
    check(results, statistical=True)
    print('ENGINE TFEP OK')


if __name__ == '__main__':
    main()
