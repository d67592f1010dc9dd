"""End-to-end TFEP with the continuous-flow map (``ContinuousEGNNMap``).

The port of ``examples/cnf_tfep.py``. A toy system with a known analytic
answer that respects the EGNN's symmetries: N atoms under a *relative*
harmonic potential (quadratic in the deviations from the centroid, so it
is translation-invariant; the EGNN velocity field preserves the
centroid):

    u(x) = sum_i |x_i - mean(x)|^2 / (2 sigma^2)

The quadratic form has 3(N-1) nonzero modes, so switching sigma_A to
sigma_B gives the reduced free-energy difference

    df = -3 (N - 1) log(sigma_B / sigma_A)    (in kT units).

Sampling x_i ~ N(0, sigma_A^2) iid makes the relative coordinates exactly
Boltzmann under u_A. A CNF with EGNN dynamics (the dense pairwise path,
as in the JAX example) is trained with per-batch Hutchinson probes,
gradient clipping and a cosine-decayed rate; the work values are then
evaluated again with the exact trace (the FEP exponential average is
biased by trace noise), and the bootstrap interval must bracket the
analytic df.

Everything runs in float64, as the JAX example does, so its tolerances
carry over, the centroid's 1e-8 among them. Run on the card, or on the
CPU with ``--device cpu``:

    python -m tfep_tpu_torch.examples.cnf_tfep [--device cpu]
"""

from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from tfep_tpu_torch.app import ContinuousEGNNMap, Trainer
from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.examples._common import (
    estimate, identity_fep, make_workdir, parse_args,
)
from tfep_tpu_torch.examples._optim import adamw, cosine_decay_schedule
from tfep_tpu_torch.io.topology import Topology
from tfep_tpu_torch.io.traj import System
from tfep_tpu_torch.units import ureg

N_FRAMES, N_ATOMS = 2048, 4
BATCH_SIZE, MAX_EPOCHS = 256, 30
SIGMA_A, SIGMA_B = 1.0, 0.75
DF_ANALYTIC = -3 * (N_ATOMS - 1) * np.log(SIGMA_B / SIGMA_A)
EVAL_CHUNK = 512
DTYPE = torch.float64


def data(n_frames: int = N_FRAMES) -> np.ndarray:
    """The frames of state A, ``(n_frames, N_ATOMS, 3)``: the JAX
    example's draws."""
    rng = np.random.default_rng(3)
    return rng.normal(0.0, SIGMA_A, size=(n_frames, N_ATOMS, 3))


def relative_potential(x_flat, sigma):
    """u(x) = sum_i |x_i - centroid|^2 / (2 sigma^2), translation-invariant
    (torch tensors or numpy arrays)."""
    pos = x_flat.reshape(*x_flat.shape[:-1], N_ATOMS, 3)
    rel = pos - pos.mean(axis=-2, keepdims=True)
    return (rel ** 2).sum(axis=(-1, -2)) / (2 * sigma ** 2)


class RelativeGaussianPotential:
    """Target potential B in kT units (energy_unit None => kT = 1)."""
    energy_unit = None

    def __call__(self, x, cell=None):
        return relative_potential(x, SIGMA_B)


def build_map(device, positions, batch_size: int = BATCH_SIZE,
              logdir=None) -> ContinuousEGNNMap:
    """2 EGNN layers of width 16, rk4 with 6 steps, Hutchinson probes
    while training, the dense pairwise block, no checkpointed solver
    steps (float64 on ``device``)."""
    return ContinuousEGNNMap(
        potential_energy_func=RelativeGaussianPotential(),
        temperature=300.0 * ureg.kelvin,
        system=System(Topology(names=['C'] * N_ATOMS), positions),
        batch_size=batch_size,
        tfep_logger_dir_path=logdir,
        r_cutoff=50.0,                      # fully connected at these sizes
        n_egnn_layers=2, node_feat_dim=16, distance_feat_dim=8,
        time_feat_dim=4, solver='rk4', n_steps=6,
        trace_estimator='hutchinson',       # per-batch probes in training
        egnn_kwargs={'pairwise': 'dense'},
        # No recompute of each solver step in the backward: at 4 atoms
        # the stored steps take little memory, and the recompute nearly
        # doubles the step's host time. The values are the same.
        cnf_kwargs={'checkpoint': False},
        device=device, dtype=DTYPE)


def optimizer(n_steps_total: int):
    """``optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
    optax.cosine_decay_schedule(2e-3, decay_steps=n_steps_total)))``."""
    return adamw(cosine_decay_schedule(2e-3, decay_steps=n_steps_total),
                 max_grad_norm=1.0)


def exact_flow(flow):
    """A shallow copy of the trained flow that evaluates the exact trace
    (it shares the trained weights)."""
    flow_exact = copy.copy(flow)
    flow_exact.trace_estimator = 'exact'
    return flow_exact


@torch.no_grad()
def exact_work_inputs(flow, x_all, chunk: int = EVAL_CHUNK):
    """``(y, log_det_J)`` of every frame through ``exact_flow(flow)``, in
    chunks. The exact trace takes forward-mode derivatives, which an
    outer ``no_grad`` leaves alone."""
    flow_exact = exact_flow(flow)
    ys, ldjs = [], []
    for start in range(0, x_all.shape[0], chunk):
        y, ldj = flow_exact(x_all[start:start + chunk])[:2]
        ys.append(y)
        ldjs.append(ldj)
    return torch.cat(ys), torch.cat(ldjs)


def run(device=None, workdir=None, n_frames: int = N_FRAMES,
        max_epochs: int = MAX_EPOCHS, batch_size: int = BATCH_SIZE,
        n_resamples: int = 500) -> dict:
    """Train with Hutchinson probes, then evaluate the work values with the
    exact trace."""
    device = resolve_device(device)
    workdir = make_workdir(workdir, 'cnf_tfep')
    positions = data(n_frames)
    steps_per_epoch = n_frames // batch_size

    tfep_map = build_map(device, positions, batch_size=batch_size,
                         logdir=os.path.join(workdir, 'logs'))
    # A pinned shuffle_seed makes the batch order reproducible; the
    # clipping and the decayed rate make training converge for every
    # order (see the JAX example).
    trainer = Trainer(save_dir=None, max_epochs=max_epochs, shuffle=True,
                      shuffle_seed=7,
                      optimizer=optimizer(max_epochs * steps_per_epoch))
    start = time.perf_counter()
    trainer.fit(tfep_map)
    wall = time.perf_counter() - start
    losses = np.asarray(trainer.loss_history)

    x_all = torch.as_tensor(positions.reshape(n_frames, -1), dtype=DTYPE,
                            device=device)
    start = time.perf_counter()
    y_all, ldj_all = exact_work_inputs(tfep_map.flow, x_all)
    eval_wall = time.perf_counter() - start

    # The EGNN field preserves the centroid.
    com_drift = float((y_all.reshape(n_frames, N_ATOMS, 3).mean(dim=1)
                       - x_all.reshape(n_frames, N_ATOMS, 3).mean(dim=1))
                      .abs().max())
    u_a = relative_potential(x_all, SIGMA_A)
    work = (relative_potential(y_all, SIGMA_B) - u_a - ldj_all).cpu().numpy()
    identity_work = (relative_potential(x_all, SIGMA_B) - u_a).cpu().numpy()
    df, low, high = estimate(work, device, n_resamples)
    return dict(df=df, ci=(low, high), df_analytic=DF_ANALYTIC, margin=0.2,
                df_fep=identity_fep(identity_work, device),
                com_drift=com_drift, var_identity=float(np.var(identity_work)),
                var_mapped=float(np.var(work)),
                first_epoch_loss=float(losses[:steps_per_epoch].mean()),
                last_epoch_loss=float(losses[-steps_per_epoch:].mean()),
                steps=trainer.global_step, wall_s=wall, eval_s=eval_wall,
                workdir=workdir)


def check(results: dict, statistical: bool = True):
    """The JAX example's asserts: the centroid drift at any size;
    ``statistical`` (the interval against the analytic df, the variance
    reduction) depends on the run's size."""
    assert results['com_drift'] < 1e-8, \
        f"centroid moved by {results['com_drift']}"
    if statistical:
        low, high = results['ci']
        assert low - 0.2 <= DF_ANALYTIC <= high + 0.2, (
            f"CNF TFEP estimate {results['df']} (CI [{low},{high}]) "
            f'misses {DF_ANALYTIC}')
        # The trained map must reduce the work variance vs the identity.
        assert results['var_mapped'] < results['var_identity']


def main(argv=None):
    args = parse_args(argv, __doc__)
    results = run(args.device, args.workdir)
    print('trained steps:', results['steps'],
          f"epoch-mean loss {results['first_epoch_loss']:.3f} -> "
          f"{results['last_epoch_loss']:.3f}")
    low, high = results['ci']
    print(f'analytic df  = {DF_ANALYTIC:.4f} kT')
    print(f"CNF TFEP df  = {results['df']:.4f} kT   "
          f'CI=[{low:.4f}, {high:.4f}]')
    print(f"standard FEP = {results['df_fep']:.4f} kT (identity map)")
    print(f"work variance: identity {results['var_identity']:.3f} -> "
          f"mapped {results['var_mapped']:.3f}")
    check(results, statistical=True)
    print('CNF TFEP OK')


if __name__ == '__main__':
    main()
