"""End-to-end TFEP on a toy Gaussian, through the port's public API.

The port of ``examples/toy_gaussian_tfep.py``. Samples of a 3D Gaussian A
(std sigma_A) and a target potential B, a Gaussian of std sigma_B, give
the analytic reduced free-energy difference

    df = -3 * log(sigma_B / sigma_A)   (in kT units).

An affine-MAF map is trained with the ``Trainer`` (a checkpoint every
step), the last epoch's logged work values give the FEP estimate with a
bootstrap interval (held against ``estimate_from_logger``), and a run cut
after 5 steps resumes from its checkpoint to step 8.

Everything runs in float64, as the JAX example does (it enables
``jax_enable_x64``), so its tolerances carry over. Run on the card, or on
the CPU with ``--device cpu``:

    python -m tfep_tpu_torch.examples.toy_gaussian_tfep [--device cpu]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tfep_tpu_torch.analysis import estimate_from_logger
from tfep_tpu_torch.app import TFEPMapBase, Trainer
from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.examples._common import (
    estimate, identity_fep, make_workdir, parse_args,
)
from tfep_tpu_torch.examples._optim import adamw
from tfep_tpu_torch.io.topology import Topology
from tfep_tpu_torch.io.traj import System
from tfep_tpu_torch.nn.conditioners import generate_degrees
from tfep_tpu_torch.nn.flows import MAF, SequentialFlow
from tfep_tpu_torch.units import ureg

N_FRAMES, N_ATOMS = 2048, 1
BATCH_SIZE, N_EPOCHS = 256, 40
SIGMA_A, SIGMA_B = 1.0, 0.7
DF_ANALYTIC = -3 * np.log(SIGMA_B / SIGMA_A)
LEARNING_RATE = 5e-3
DTYPE = torch.float64


def data(n_frames: int = N_FRAMES) -> np.ndarray:
    """The frames of state A, ``(n_frames, N_ATOMS, 3)``: the JAX
    example's draws."""
    rng = np.random.default_rng(0)
    return rng.normal(0.0, SIGMA_A, size=(n_frames, N_ATOMS, 3))


def reduced_potential(x, sigma: float):
    """u/kT of flattened ``(batch, 3 * n_atoms)`` positions (tensors or
    numpy arrays) under a Gaussian of std ``sigma``."""
    return (x ** 2).sum(-1) / (2 * sigma ** 2)


class GaussianPotential:
    """Target potential B in kT units (energy_unit None => kT = 1)."""
    energy_unit = None

    def __call__(self, x, cell=None):
        return reduced_potential(x, SIGMA_B)


class ToyMap(TFEPMapBase):
    """Two affine MAF layers, in ascending and descending order."""

    def configure_flow(self):
        n_dofs = self.dataset.n_atoms * 3
        return SequentialFlow.create(*[
            MAF.create(torch.Generator().manual_seed(self.seed + i),
                       generate_degrees(n_dofs, order=order),
                       device=self.device, dtype=self.dtype)
            for i, order in enumerate(('ascending', 'descending'))],
            device=self.device)


def build_map(device, positions, logdir=None) -> ToyMap:
    """The example's map over ``positions`` (float64 on ``device``)."""
    return ToyMap(potential_energy_func=GaussianPotential(),
                  temperature=300.0 * ureg.kelvin,
                  system=System(Topology(names=['C'] * positions.shape[1]),
                                positions),
                  batch_size=BATCH_SIZE, tfep_logger_dir_path=logdir,
                  device=device, dtype=DTYPE)


def optimizer():
    """``optax.adamw(5e-3)``."""
    return adamw(LEARNING_RATE)


def run(device=None, workdir=None, n_frames: int = N_FRAMES,
        n_epochs: int = N_EPOCHS, n_resamples: int = 500) -> dict:
    """Train, estimate, then cut and resume a run; returns what
    :func:`check` reads."""
    device = resolve_device(device)
    workdir = make_workdir(workdir, 'toy_gaussian_tfep')
    positions = data(n_frames)
    x_flat = positions.reshape(n_frames, -1)

    tfep_map = build_map(device, positions,
                         logdir=os.path.join(workdir, 'logs'))
    trainer = Trainer(save_dir=os.path.join(workdir, 'ckpt'),
                      max_epochs=n_epochs, shuffle=True,
                      optimizer=optimizer())
    start = time.perf_counter()
    trainer.fit(tfep_map)
    wall = time.perf_counter() - start

    # The last epoch's logged work values against the reference
    # potential u_A of the same frames.
    epoch = trainer.current_epoch - 1
    logged = tfep_map.tfep_logger.read_train_tensors(epoch_idx=epoch)
    u_a = reduced_potential(x_flat, SIGMA_A)
    work = (logged['potential'] - logged['log_det_J']
            - u_a[logged['dataset_sample_index'].astype(int)])
    df, low, high = estimate(work, device, n_resamples)
    one_call = estimate_from_logger(
        tfep_map.tfep_logger, epoch_idx=epoch, reference_potentials=u_a,
        n_resamples=n_resamples, seed=1, device=device)

    # A run cut after 5 steps, resumed from its checkpoint to step 8.
    ckpt = os.path.join(workdir, 'resume_ckpt')
    cut = Trainer(save_dir=ckpt, max_steps=5, shuffle=True)
    cut.fit(build_map(device, positions))
    resumed = Trainer(save_dir=ckpt, max_steps=8, shuffle=True)
    resumed.fit(build_map(device, positions), resume=True)

    return dict(
        df=df, ci=(low, high), df_analytic=DF_ANALYTIC, margin=0.15,
        df_one_call=float(one_call['df']),
        df_fep=identity_fep(reduced_potential(x_flat, SIGMA_B) - u_a,
                            device),
        steps=trainer.global_step, wall_s=wall,
        steps_before_cut=cut.global_step, steps_resumed=resumed.global_step,
        workdir=workdir)


def check(results: dict, statistical: bool = True):
    """The JAX example's asserts, its margins unchanged; ``statistical``
    (the interval against the analytic df) depends on the run's size."""
    assert abs(results['df_one_call'] - results['df']) < 1e-6, (
        results['df_one_call'], results['df'])
    assert results['steps_before_cut'] == 5
    assert results['steps_resumed'] == 8
    if statistical:
        low, high = results['ci']
        assert low - 0.15 <= DF_ANALYTIC <= high + 0.15, (
            f"TFEP estimate {results['df']} (CI [{low},{high}]) misses "
            f'analytic {DF_ANALYTIC}')


def main(argv=None):
    args = parse_args(argv, __doc__)
    results = run(args.device, args.workdir)
    print('trained steps:', results['steps'])
    print(f'analytic df  = {DF_ANALYTIC:.4f} kT')
    low, high = results['ci']
    print(f"TFEP df      = {results['df']:.4f} kT   "
          f'CI=[{low:.4f}, {high:.4f}]')
    print(f"standard FEP = {results['df_fep']:.4f} kT (identity map)")
    print('post-resume steps:', results['steps_resumed'], '(resumed from 5)')
    check(results, statistical=True)
    print('VERIFY OK')


if __name__ == '__main__':
    main()
