"""Multimap TFEP with the ``MixedMAFMap``, validated by quadrature.

The port of ``examples/multimap_tfep_mixed.py``. A 5-atom bent chain whose
reduced potential is harmonic in a fixed set of internal coordinates (the
three reference-frame coordinates d01, d02, a102 plus a bond, an angle and
a torsion per additional atom). The Cartesian measure factorizes over
these coordinates with weights d01^2 d02^2 sin(a102) and r^2 sin(theta) per
Z-matrix row, so the exact free-energy difference between state A and a
target B with stretched equilibrium bonds is a product of 1D quadratures.

State A is sampled by Metropolis MC in Cartesian coordinates; the map is a
``MixedMAFMap`` (automatic Z-matrix, spline MAF in internal coordinates,
whose bonds and angles run the fused spline kernels K1/K2 on the card);
the multimap estimator pools the work values logged over the later
training epochs.

Everything runs in float64, as the JAX example does, so its tolerances
carry over. Run on the card, or on the CPU with ``--device cpu``:

    python -m tfep_tpu_torch.examples.multimap_tfep_mixed [--device cpu]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tfep_tpu_torch.app import MixedMAFMap, Trainer
from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.examples._common import (
    estimate, identity_fep, make_workdir, parse_args,
)
from tfep_tpu_torch.examples._optim import adamw
from tfep_tpu_torch.examples.multimap_tfep_triatomic import multimap_work
from tfep_tpu_torch.io.topology import Topology
from tfep_tpu_torch.io.traj import System
from tfep_tpu_torch.units import ureg

# 5-atom chain 0-1-2-3-4. Internal coordinates for the potential:
# frame atoms (1 origin, 0 axis, 2 plane): d01=|r0-r1|, d02=|r2-r1|,
# a102=angle(0-1-2); atom 3: bond 3-2, angle 3-2-1, torsion 3-2-1-0;
# atom 4: bond 4-3, angle 4-3-2, torsion 4-3-2-1.
K_BOND = 400.0      # 1/kT/A^2
K_ANGLE = 120.0     # 1/kT/rad^2
K_TORSION = 15.0    # 1/kT/rad^2
R0_A, R0_B = 1.4, 1.6
THETA0 = 1.9
PHI0 = 1.0

N_SAMPLES = 2048
N_EPOCHS = 30
N_ESTIMATION_EPOCHS = 15
BATCH_SIZE = 256
LEARNING_RATE = 2e-3
DTYPE = torch.float64


def internal_coords(pos):
    """Internal coordinates from (batch, 5, 3) positions (tensors or
    numpy arrays)."""
    if isinstance(pos, torch.Tensor):
        xp, cross = torch, torch.linalg.cross
    else:
        xp, cross = np, np.cross

    def norm(v):
        return xp.sqrt(xp.sum(v * v, axis=-1))

    def angle(v1, v2):
        cos = xp.sum(v1 * v2, axis=-1) / (norm(v1) * norm(v2))
        return xp.arccos(xp.clip(cos, -1.0, 1.0))

    def dihedral(p0, p1, p2, p3):
        b1 = p1 - p0
        b2 = p2 - p1
        b3 = p3 - p2
        n1 = cross(b1, b2)
        n2 = cross(b2, b3)
        m = cross(n1, b2 / norm(b2)[..., None])
        x = xp.sum(n1 * n2, axis=-1)
        y = xp.sum(m * n2, axis=-1)
        return xp.arctan2(y, x)

    d01 = norm(pos[:, 0] - pos[:, 1])
    d02 = norm(pos[:, 2] - pos[:, 1])
    a102 = angle(pos[:, 0] - pos[:, 1], pos[:, 2] - pos[:, 1])
    b3 = norm(pos[:, 3] - pos[:, 2])
    a3 = angle(pos[:, 3] - pos[:, 2], pos[:, 1] - pos[:, 2])
    t3 = dihedral(pos[:, 3], pos[:, 2], pos[:, 1], pos[:, 0])
    b4 = norm(pos[:, 4] - pos[:, 3])
    a4 = angle(pos[:, 4] - pos[:, 3], pos[:, 2] - pos[:, 3])
    t4 = dihedral(pos[:, 4], pos[:, 3], pos[:, 2], pos[:, 1])
    return d01, d02, a102, b3, a3, t3, b4, a4, t4


def reduced_potential(x, r0):
    """u/kT for flattened (batch, 15) coordinates."""
    pos = x.reshape(x.shape[0], 5, 3)
    d01, d02, a102, b3, a3, t3, b4, a4, t4 = internal_coords(pos)
    u = 0.5 * K_BOND * ((d01 - r0) ** 2 + (d02 - r0) ** 2
                        + (b3 - r0) ** 2 + (b4 - r0) ** 2)
    u = u + 0.5 * K_ANGLE * ((a102 - THETA0) ** 2 + (a3 - THETA0) ** 2
                             + (a4 - THETA0) ** 2)
    u = u + 0.5 * K_TORSION * ((t3 - PHI0) ** 2 + (t4 - PHI0) ** 2)
    return u


class TargetPotential:
    energy_unit = None

    def __call__(self, x, cell=None):
        return reduced_potential(x, R0_B)


def analytic_df():
    """Quadrature over the factorized internal-coordinate measure."""
    r = np.linspace(0.5, 3.5, 40001)
    t = np.linspace(1e-4, np.pi - 1e-4, 40001)
    phi = np.linspace(-np.pi, np.pi, 40001)

    def z(r0):
        z_r2 = np.trapezoid(r ** 2 * np.exp(-0.5 * K_BOND * (r - r0) ** 2), r)
        z_sin = np.trapezoid(
            np.sin(t) * np.exp(-0.5 * K_ANGLE * (t - THETA0) ** 2), t)
        z_phi = np.trapezoid(
            np.exp(-0.5 * K_TORSION * (phi - PHI0) ** 2), phi)
        # 4 bonds with r^2 weight, 3 angles with sin weight, 2 torsions flat.
        return z_r2 ** 4 * z_sin ** 3 * z_phi ** 2

    return -np.log(z(R0_B) / z(R0_A))


def base_geometry():
    """A bent starting structure consistent with the equilibrium ICs."""
    pos = np.zeros((5, 3))
    pos[1] = [0.0, 0.0, 0.0]
    pos[0] = [R0_A, 0.0, 0.0]
    pos[2] = R0_A * np.array([np.cos(THETA0), np.sin(THETA0), 0.0])
    # Place 3 and 4 by rough NeRF-style growth; MC relaxes them.
    pos[3] = pos[2] + R0_A * np.array([np.cos(THETA0 - 0.9),
                                       np.sin(THETA0 - 0.9), 0.4])
    pos[4] = pos[3] + R0_A * np.array([0.3, 0.6, 0.74])
    return pos


def sample_reference(n_samples, seed=0, n_burn=800, thin=25, n_walkers=64):
    rng = np.random.default_rng(seed)
    pos = np.tile(base_geometry()[None], (n_walkers, 1, 1))
    pos += 0.01 * rng.normal(size=pos.shape)
    u = reduced_potential(pos.reshape(n_walkers, -1), R0_A)

    samples = []
    step_size = 0.025
    n_rounds = n_burn + (n_samples // n_walkers + 1) * thin
    for it in range(n_rounds):
        prop = pos + step_size * rng.normal(size=pos.shape)
        u_prop = reduced_potential(prop.reshape(n_walkers, -1), R0_A)
        accept = np.log(rng.random(n_walkers)) < u - u_prop
        pos[accept] = prop[accept]
        u[accept] = u_prop[accept]
        if it >= n_burn and (it - n_burn) % thin == 0:
            samples.append(pos.copy())
    return np.concatenate(samples)[:n_samples]


def data(n_samples: int = N_SAMPLES) -> np.ndarray:
    """The frames of state A, ``(n_samples, 5, 3)``."""
    return sample_reference(n_samples)


def build_map(device, positions, logdir=None) -> MixedMAFMap:
    """The ``MixedMAFMap`` with 4 MAF layers (float64 on ``device``)."""
    topology = Topology(names=['C1', 'C2', 'C3', 'C4', 'C5'],
                        elements=['C'] * 5,
                        bonds=[(0, 1), (1, 2), (2, 3), (3, 4)])
    return MixedMAFMap(
        potential_energy_func=TargetPotential(),
        temperature=300.0 * ureg.kelvin,
        system=System(topology, positions),
        batch_size=BATCH_SIZE,
        n_maf_layers=4,
        tfep_logger_dir_path=logdir, device=device, dtype=DTYPE)


def optimizer():
    """``optax.adamw(2e-3)``."""
    return adamw(LEARNING_RATE)


def run(device=None, workdir=None, n_samples: int = N_SAMPLES,
        n_epochs: int = N_EPOCHS,
        n_estimation_epochs: int = N_ESTIMATION_EPOCHS,
        n_resamples: int = 500) -> dict:
    """Sample, train, and pool the last epochs' work values."""
    device = resolve_device(device)
    workdir = make_workdir(workdir, 'multimap_tfep_mixed')
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
                margin=0.25,
                df_fep=identity_fep(reduced_potential(x, R0_B) - u_a,
                                    device),
                steps=trainer.global_step, wall_s=wall, workdir=workdir)


def check(results: dict, statistical: bool = True):
    """The JAX example's assert (the interval against the quadrature, with
    its margin), which depends on the run's size."""
    if statistical:
        low, high = results['ci']
        assert low - 0.25 < results['df_analytic'] < high + 0.25, \
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
    print('MIXED MULTIMAP TFEP OK')


if __name__ == '__main__':
    main()
