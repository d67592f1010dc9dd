"""Multimap targeted free energy perturbation on a triatomic toy molecule.

The port of ``examples/multimap_tfep_triatomic.py`` (the workflow of the
tutorial ``docs/intro_to_MTFEP_torch.ipynb``, arXiv:2302.07683): a linear
triatomic with two harmonic bonds and a harmonic angle, reference state A
(equilibrium bond length r0A) sampled by Metropolis Monte Carlo, target
state B with a longer r0B. The map is a ``CartesianMAFMap`` with the
central atom pinned at the origin and the outer atoms fixing the axes.
The *multimap* estimator pools the per-sample work values logged over the
last training epochs (each under a progressively better map).

The exact answer comes from 1D quadrature of the internal-coordinate
partition functions:

    Z = [int r^2 e^{-beta k (r-r0)^2 / 2} dr]^2
        * int sin(t) e^{-beta kt (t-t0)^2/2} dt

Everything runs in float64, as the JAX example does, so its tolerances
carry over. Run on the card, or on the CPU with ``--device cpu``:

    python -m tfep_tpu_torch.examples.multimap_tfep_triatomic [--device cpu]
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
from tfep_tpu_torch.examples._optim import adamw
from tfep_tpu_torch.io.topology import Topology
from tfep_tpu_torch.io.traj import System
from tfep_tpu_torch.units import ureg

# System parameters (the tutorial's, in kT units at 300 K).
KT_KCAL = 0.5961615
K_R = 290.1 / KT_KCAL      # bond constant [1/kT/A^2]
K_A = 900.0 / KT_KCAL      # angle constant [1/kT/rad^2]
R0_A = 1.278               # reference equilibrium bond length [A]
R0_B = 1.5                 # target equilibrium bond length [A]
THETA0 = 2.038             # equilibrium angle [rad]

N_SAMPLES = 4096
N_EPOCHS = 40
N_ESTIMATION_EPOCHS = 20  # use the last (best-trained) epochs
BATCH_SIZE = 256
LEARNING_RATE = 2e-3
DTYPE = torch.float64


def reduced_potential(x, r0):
    """u/kT for flattened (batch, 9) coordinates of atoms [0, 1, 2]: torch
    tensors (the map's target) or numpy arrays."""
    if not isinstance(x, torch.Tensor):
        return _u_numpy(np.asarray(x).reshape(x.shape[0], 3, 3), r0)
    pos = x.reshape(x.shape[0], 3, 3)
    r10 = pos[:, 0] - pos[:, 1]
    r12 = pos[:, 2] - pos[:, 1]
    d10 = torch.linalg.norm(r10, dim=-1)
    d12 = torch.linalg.norm(r12, dim=-1)
    cos_t = torch.sum(r10 * r12, dim=-1) / (d10 * d12)
    theta = torch.arccos(torch.clamp(cos_t, -1.0, 1.0))
    return (0.5 * K_R * ((d10 - r0) ** 2 + (d12 - r0) ** 2)
            + 0.5 * K_A * (theta - THETA0) ** 2)


class TargetPotential:
    """State-B potential in kT units (energy_unit None => kT = 1)."""
    energy_unit = None

    def __call__(self, x, cell=None):
        return reduced_potential(x, R0_B)


def _u_numpy(pos, r0):
    """Reduced potential for (walkers, 3, 3) positions, pure numpy."""
    r10 = pos[:, 0] - pos[:, 1]
    r12 = pos[:, 2] - pos[:, 1]
    d10 = np.linalg.norm(r10, axis=-1)
    d12 = np.linalg.norm(r12, axis=-1)
    cos_t = np.sum(r10 * r12, axis=-1) / (d10 * d12)
    theta = np.arccos(np.clip(cos_t, -1.0, 1.0))
    return (0.5 * K_R * ((d10 - r0) ** 2 + (d12 - r0) ** 2)
            + 0.5 * K_A * (theta - THETA0) ** 2)


def sample_reference(n_samples, seed=0, n_burn=500, thin=20, n_walkers=64):
    """Metropolis MC in Cartesian coordinates of state A (vectorized)."""
    rng = np.random.default_rng(seed)
    pos0 = np.array([[R0_A * np.sin(THETA0 / 2), R0_A * np.cos(THETA0 / 2),
                      0.0],
                     [0.0, 0.0, 0.0],
                     [-R0_A * np.sin(THETA0 / 2), R0_A * np.cos(THETA0 / 2),
                      0.0]])
    pos = np.tile(pos0[None], (n_walkers, 1, 1))
    pos += 0.01 * rng.normal(size=pos.shape)
    u = _u_numpy(pos, R0_A)

    samples = []
    step_size = 0.03
    n_rounds = n_burn + (n_samples // n_walkers + 1) * thin
    for it in range(n_rounds):
        prop = pos + step_size * rng.normal(size=pos.shape)
        u_prop = _u_numpy(prop, R0_A)
        accept = np.log(rng.random(n_walkers)) < u - u_prop
        pos[accept] = prop[accept]
        u[accept] = u_prop[accept]
        if it >= n_burn and (it - n_burn) % thin == 0:
            samples.append(pos.copy())
    return np.concatenate(samples)[:n_samples]


def data(n_samples: int = N_SAMPLES) -> np.ndarray:
    """The frames of state A, ``(n_samples, 3, 3)``."""
    return sample_reference(n_samples)


def analytic_df():
    """Exact reduced free-energy difference by quadrature."""
    r = np.linspace(0.5, 3.0, 20001)
    t = np.linspace(0.5, np.pi, 20001)

    def z(r0):
        zr = np.trapezoid(r ** 2 * np.exp(-0.5 * K_R * (r - r0) ** 2), r)
        zt = np.trapezoid(np.sin(t) * np.exp(-0.5 * K_A * (t - THETA0) ** 2),
                          t)
        return zr ** 2 * zt

    return -np.log(z(R0_B) / z(R0_A))


def build_map(device, positions, logdir=None) -> CartesianMAFMap:
    """Central atom at the origin, outer atoms fixing the axes; 4 MAF
    layers of two hidden layers of 64 (float64 on ``device``)."""
    topology = Topology(names=['O1', 'O2', 'O3'], elements=['O', 'O', 'O'],
                        bonds=[(0, 1), (1, 2)])
    return CartesianMAFMap(
        potential_energy_func=TargetPotential(),
        temperature=300.0 * ureg.kelvin,
        system=System(topology, positions),
        batch_size=BATCH_SIZE,
        mapped_atoms=[0, 2],
        conditioning_atoms=[1],
        origin_atom=1,
        axes_atoms=[0, 2],
        n_maf_layers=4,
        flow_kwargs=dict(hidden_layers=[64, 64]),
        tfep_logger_dir_path=logdir, device=device, dtype=DTYPE)


def optimizer():
    """``optax.adamw(2e-3)``."""
    return adamw(LEARNING_RATE)


def multimap_work(logger, u_a, epochs) -> np.ndarray:
    """The logged work values of ``epochs``, concatenated."""
    works = []
    for epoch in epochs:
        logged = logger.read_train_tensors(epoch_idx=epoch)
        idx = logged['dataset_sample_index'].astype(int)
        works.append(logged['potential'] - logged['log_det_J'] - u_a[idx])
    return np.concatenate(works)


def run(device=None, workdir=None, n_samples: int = N_SAMPLES,
        n_epochs: int = N_EPOCHS,
        n_estimation_epochs: int = N_ESTIMATION_EPOCHS,
        n_resamples: int = 1000) -> dict:
    """Sample, train, and pool the last epochs' work values."""
    device = resolve_device(device)
    workdir = make_workdir(workdir, 'multimap_tfep_triatomic')
    positions = data(n_samples)
    x = positions.reshape(n_samples, -1)
    u_a = reduced_potential(x, R0_A)

    tfep_map = build_map(device, positions,
                         logdir=os.path.join(workdir, 'logs'))
    trainer = Trainer(save_dir=None, max_epochs=n_epochs, shuffle=True,
                      optimizer=optimizer())
    start = time.perf_counter()
    trainer.fit(tfep_map)
    wall = time.perf_counter() - start

    work = multimap_work(tfep_map.tfep_logger, u_a,
                         range(n_epochs - n_estimation_epochs, n_epochs))
    df, low, high = estimate(work, device, n_resamples)
    return dict(df=df, ci=(low, high), df_analytic=analytic_df(),
                margin=0.2,
                df_fep=identity_fep(reduced_potential(x, R0_B) - u_a,
                                    device),
                steps=trainer.global_step, wall_s=wall, workdir=workdir)


def check(results: dict, statistical: bool = True):
    """The JAX example's assert (the interval against the quadrature, with
    its margin), which depends on the run's size."""
    if statistical:
        low, high = results['ci']
        assert low - 0.2 < results['df_analytic'] < high + 0.2, \
            'TFEP estimate missed the target'


def main(argv=None):
    args = parse_args(argv, __doc__)
    results = run(args.device, args.workdir)
    print(f"analytic df     = {results['df_analytic']:.4f} kT")
    print(f"standard FEP df = {results['df_fep']:.4f} kT")
    low, high = results['ci']
    print(f"multimap TFEP df = {results['df']:.4f} kT   "
          f'CI=[{low:.4f}, {high:.4f}]')
    print(f"|error| = {abs(results['df'] - results['df_analytic']):.4f} kT")
    check(results, statistical=True)
    print('MULTIMAP TFEP OK')


if __name__ == '__main__':
    main()
