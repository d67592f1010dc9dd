"""TFEP with the full pre-flow stack: CenteredCentroid + Oriented + PCA.

The port of ``examples/solvated_preflow_tfep.py``: a neural-spline MAF on
a solvated-ligand-like system (synthetic, so the answer is analytic) with
the reference-frame pre-flows and PCA whitening, through the app layer
(``CartesianMAFMap(pca_whitening=True, origin_atom=..., axes_atoms=...)``).

The system: 14 atoms (an 8-atom "ligand" and 6 "solvent" atoms) whose
state-A ensemble is a correlated, anisotropic 42-dimensional Gaussian
N(t, S_A); the target state B is the same Gaussian contracted by a factor
c, S_B = c^2 S_A. The analytic reduced free-energy difference is

    df = -0.5 * log det(S_B S_A^-1) = -42 * log(c)   (kT units).

In PCA-whitened coordinates the optimal map is a per-feature contraction,
which the spline MAF learns in a few hundred steps. The spline is in its
standard configuration, so on the card its forward and backward run the
fused kernels (K1/K2 of ``tfep_tpu_torch.ops.spline``), here in float64.
The estimate uses held-out frames through the evaluation channel, immune
to the training-set overfitting of an expressive map.

Everything runs in float64, as the JAX example does, so its tolerances
carry over. Run on the card, or on the CPU with ``--device cpu``:

    python -m tfep_tpu_torch.examples.solvated_preflow_tfep [--device cpu]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tfep_tpu_torch.app import CartesianMAFMap, Trainer
from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.examples._common import (
    estimate, identity_fep, make_workdir, parse_args,
)
from tfep_tpu_torch.examples._optim import adamw, cosine_decay_schedule
from tfep_tpu_torch.io.topology import Topology
from tfep_tpu_torch.io.traj import System, TrajectoryDataset
from tfep_tpu_torch.nn.transformers import NeuralSplineTransformer
from tfep_tpu_torch.units import ureg

N_LIGAND, N_SOLVENT = 8, 6
N_ATOMS = N_LIGAND + N_SOLVENT
N_DOFS = 3 * N_ATOMS
N_FRAMES = 4096
CONTRACTION = 0.72
DF_ANALYTIC = -N_DOFS * np.log(CONTRACTION)
# 36 MAF features: 42 DOFs minus origin xyz, axis-atom xy, plane-atom y.
N_FLOW_FEATURES = N_DOFS - 6
N_BINS = 8
BATCH_SIZE, N_EPOCHS = 512, 40
DTYPE = torch.float64


def data(n_frames: int = N_FRAMES) -> dict:
    """The Gaussian of state A and its frames: the JAX example's draws,
    in its order, from one generator (the training frames, then the
    held-out ones)."""
    rng = np.random.default_rng(3)
    ligand_mean = rng.normal(0.0, 1.2, size=(N_LIGAND, 3))
    solvent_mean = 3.0 * rng.normal(0.0, 1.0, size=(N_SOLVENT, 3))
    mean = np.concatenate([ligand_mean, solvent_mean]).reshape(-1)

    mixing = np.eye(N_DOFS) + 0.25 * rng.normal(size=(N_DOFS, N_DOFS))
    cov_a = 0.15 * mixing @ mixing.T
    chol_a = np.linalg.cholesky(cov_a)
    precision_b = np.linalg.inv(cov_a) / CONTRACTION ** 2

    positions = mean + rng.normal(size=(n_frames, N_DOFS)) @ chol_a.T
    eval_positions = mean + rng.normal(size=(n_frames, N_DOFS)) @ chol_a.T
    u_a_eval = 0.5 * np.einsum('fi,ij,fj->f', eval_positions - mean,
                               np.linalg.inv(cov_a), eval_positions - mean)
    return dict(mean=mean, cov_a=cov_a, precision_b=precision_b,
                positions=positions, eval_positions=eval_positions,
                u_a_eval=u_a_eval)


def topology() -> Topology:
    return Topology(
        names=[f'C{i}' for i in range(N_LIGAND)]
        + [f'O{i}' for i in range(N_SOLVENT)],
        elements=['C'] * N_LIGAND + ['O'] * N_SOLVENT,
        resnames=['MOL'] * N_LIGAND + ['SOL'] * N_SOLVENT,
        resids=[1] * N_LIGAND + list(range(2, 2 + N_SOLVENT)))


class ContractedGaussianPotential:
    """u_B in kT units (energy_unit None => kT = 1), of torch tensors (the
    map's target) or numpy arrays."""
    energy_unit = None

    def __init__(self, mean, precision_b):
        self.mean = np.asarray(mean)
        self.precision_b = np.asarray(precision_b)
        self._on = {}

    def __call__(self, x, cell=None):
        if not isinstance(x, torch.Tensor):
            delta = np.asarray(x) - self.mean
            return 0.5 * np.einsum('fi,ij,fj->f', delta, self.precision_b,
                                   delta)
        key = (x.device, x.dtype)
        if key not in self._on:
            self._on[key] = tuple(
                torch.as_tensor(a, dtype=x.dtype, device=x.device)
                for a in (self.mean, self.precision_b))
        mean, precision = self._on[key]
        delta = x - mean
        return 0.5 * torch.einsum('fi,ij,fj->f', delta, precision, delta)

    def __getstate__(self):
        return dict(self.__dict__, _on={})


def build_map(device, frames: dict, logdir=None) -> CartesianMAFMap:
    """The spline MAF (2 layers on [-8, 8], 8 bins) behind the
    centroid, orientation and PCA pre-flows (float64 on ``device``)."""
    # Domain well beyond the whitened data range (~N(0,1)): the spline's
    # edge-pinned region then lies where no sample ever falls.
    spline = NeuralSplineTransformer(
        x0=-8.0 * np.ones(N_FLOW_FEATURES), xf=8.0 * np.ones(N_FLOW_FEATURES),
        n_bins=N_BINS, device=device, dtype=DTYPE)
    n_frames = frames['positions'].shape[0]
    return CartesianMAFMap(
        potential_energy_func=ContractedGaussianPotential(
            frames['mean'], frames['precision_b']),
        temperature=300.0 * ureg.kelvin,
        system=System(topology(),
                      frames['positions'].reshape(n_frames, N_ATOMS, 3)),
        batch_size=BATCH_SIZE,
        mapped_atoms=list(range(1, N_ATOMS)),
        conditioning_atoms=[0],
        origin_atom=0,
        axes_atoms=[1, 2],
        pca_whitening=True,
        n_maf_layers=2,
        flow_kwargs=dict(transformer=spline),
        tfep_logger_dir_path=logdir, device=device, dtype=DTYPE)


def optimizer():
    """``optax.adamw(optax.cosine_decay_schedule(3e-3, 800, alpha=0.05))``."""
    return adamw(cosine_decay_schedule(3e-3, 800, alpha=0.05))


def run(device=None, workdir=None, n_frames: int = N_FRAMES,
        n_epochs: int = N_EPOCHS, n_resamples: int = 500) -> dict:
    """Train, then estimate on the held-out frames."""
    device = resolve_device(device)
    workdir = make_workdir(workdir, 'solvated_preflow_tfep')
    frames = data(n_frames)

    tfep_map = build_map(device, frames,
                         logdir=os.path.join(workdir, 'logs'))
    trainer = Trainer(save_dir=None, max_epochs=n_epochs, shuffle=True,
                      log_every_n_steps=200, optimizer=optimizer())
    start = time.perf_counter()
    trainer.fit(tfep_map)
    wall = time.perf_counter() - start

    # The held-out frames through the evaluation channel.
    tfep_map.dataset = TrajectoryDataset(System(
        topology(), frames['eval_positions'].reshape(n_frames, N_ATOMS, 3)))
    tfep_map.run_evaluation(step_idx=trainer.global_step)
    logged = tfep_map.tfep_logger.read_eval_tensors(
        step_idx=trainer.global_step, sort_by='dataset_sample_index')
    u_a = frames['u_a_eval'][logged['dataset_sample_index'].astype(int)]
    work = logged['potential'] - logged['log_det_J'] - u_a
    df, low, high = estimate(work, device, n_resamples)

    # Naive FEP with the identity map for contrast.
    naive_work = ContractedGaussianPotential(
        frames['mean'], frames['precision_b'])(frames['eval_positions']) \
        - frames['u_a_eval']
    return dict(df=df, ci=(low, high), df_analytic=DF_ANALYTIC, margin=0.4,
                work_std=float(np.std(work)),
                df_fep=identity_fep(naive_work, device),
                naive_work_std=float(np.std(naive_work)),
                steps=trainer.global_step, wall_s=wall, workdir=workdir)


def check(results: dict, statistical: bool = True):
    """The JAX example's assert (the held-out interval against the
    analytic df, with its margin), which depends on the run's size."""
    if statistical:
        low, high = results['ci']
        assert low - 0.4 <= DF_ANALYTIC <= high + 0.4, (
            f"TFEP estimate {results['df']} (CI [{low},{high}]) misses "
            f'analytic {DF_ANALYTIC}')


def main(argv=None):
    args = parse_args(argv, __doc__)
    results = run(args.device, args.workdir)
    print('trained steps:', results['steps'])
    low, high = results['ci']
    print(f'analytic df  = {DF_ANALYTIC:.3f} kT')
    print(f"TFEP df      = {results['df']:.3f} kT   "
          f"CI=[{low:.3f}, {high:.3f}]  work std {results['work_std']:.2f} kT")
    print(f"naive FEP    = {results['df_fep']:.3f} kT (identity map, "
          f"error {abs(results['df_fep'] - DF_ANALYTIC):.2f} kT, "
          f"work std {results['naive_work_std']:.2f} kT)")
    check(results, statistical=True)
    print('PREFLOW TFEP OK')


if __name__ == '__main__':
    main()
