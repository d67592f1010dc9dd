"""Seed-ensemble TFEP: K maps trained at once through ``torch.func.vmap``.

The port of ``examples/ensemble_tfep.py``. K = 4 affine-MAF maps, seeded
apart, are trained on the toy Gaussian (analytic df = -3 log(sigma_B /
sigma_A), the system of :mod:`~tfep_tpu_torch.examples.toy_gaussian_tfep`)
in one vmapped training loop (:mod:`tfep_tpu_torch.nn.ensemble`); df is
then estimated per member. The members' spread is an estimate of the
map's uncertainty that a single training run cannot give. Every member
sees the same batches; only the initialization seeds differ.

Everything runs in float64, as the JAX example does, so its tolerances
carry over. Run on the card, or on the CPU with ``--device cpu``:

    python -m tfep_tpu_torch.examples.ensemble_tfep [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tfep_tpu_torch.analysis import fep_estimator
from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.examples._common import parse_args
from tfep_tpu_torch.examples._optim import adamw
from tfep_tpu_torch.examples.toy_gaussian_tfep import (
    DF_ANALYTIC, N_FRAMES, SIGMA_A, GaussianPotential, build_map, data,
    reduced_potential,
)
from tfep_tpu_torch.nn.ensemble import (
    ensemble_init, ensemble_map, make_ensemble_train_step, stack_modules,
    unstack_module,
)

K_MEMBERS = 4
BATCH = 256
N_EPOCHS = 30
LEARNING_RATE = 5e-3


def build_ensemble(device, positions):
    """The map that provides the dataset and the loss, and the stacked
    flows of its ``configure_flow`` at seeds ``100 * k``."""
    tfep_map = build_map(device, positions)
    tfep_map.setup()
    members = []
    for k in range(K_MEMBERS):
        tfep_map.seed = 100 * k
        members.append(tfep_map.configure_flow())
    return tfep_map, stack_modules(members)


def optimizer():
    """``optax.adamw(5e-3)``."""
    return adamw(LEARNING_RATE)


def make_step(tfep_map, stacked):
    """The vmapped training step of ``stacked`` and its optimizer."""
    return make_ensemble_train_step(
        lambda flow, batch: tfep_map.training_step_fn(flow, batch),
        ensemble_init(optimizer(), stacked), has_aux=True)


def batches(tfep_map, n_frames: int, n_epochs: int):
    """The batches of every epoch, on the map's device: the JAX
    example's permutations (``default_rng(7)``)."""
    shuffle_rng = np.random.default_rng(7)
    for _ in range(n_epochs):
        perm = shuffle_rng.permutation(n_frames)
        for start in range(0, n_frames, BATCH):
            idx = perm[start:start + BATCH]
            yield tfep_map.batch_to_device(
                tfep_map.dataset.get_batch(idx.tolist()))


def member_work_fn(tfep_map, x, u_a):
    """``flow -> work`` of every frame of ``x`` under one member."""
    def member_work(flow):
        out = tfep_map.forward_step_fn(flow, {'positions': x})
        u_b = GaussianPotential()(out['positions'])
        return u_b - out['log_det_J'] - u_a
    return member_work


def run(device=None, workdir=None, n_frames: int = N_FRAMES,
        n_epochs: int = N_EPOCHS) -> dict:
    """Train the K members and estimate df per member (``workdir`` is
    unused: the ensemble writes nothing)."""
    device = resolve_device(device)
    positions = data(n_frames)
    tfep_map, stacked = build_ensemble(device, positions)
    step = make_step(tfep_map, stacked)

    start = time.perf_counter()
    n_steps = 0
    for batch in batches(tfep_map, n_frames, n_epochs):
        losses, _ = step(stacked, batch)
        n_steps += 1
    losses = losses.detach().cpu().numpy()
    wall = time.perf_counter() - start

    # Per-member df over the full dataset (vmapped forward).
    x = torch.as_tensor(positions.reshape(n_frames, -1),
                        dtype=tfep_map.dtype, device=device)
    u_a = reduced_potential(x, SIGMA_A)
    member_work = member_work_fn(tfep_map, x, u_a)
    with torch.no_grad():
        works = ensemble_map(member_work, stacked)           # (K, n_frames)
        w0 = member_work(unstack_module(stacked, 0))
    dfs = np.array([float(fep_estimator(w)) for w in works])
    p0 = [p.detach().cpu() for p in unstack_module(stacked, 0).parameters()]
    p1 = [p.detach().cpu() for p in unstack_module(stacked, 1).parameters()]
    return dict(dfs=dfs, df=float(dfs.mean()), spread=float(dfs.std()),
                df_analytic=DF_ANALYTIC, margin=0.1, final_losses=losses,
                members_differ=any(not torch.equal(a, b)
                                   for a, b in zip(p0, p1)),
                member_0_work=w0.cpu().numpy(),
                vmapped_work_0=works[0].cpu().numpy(),
                steps=n_steps, wall_s=wall)


def check(results: dict, statistical: bool = True):
    """The JAX example's asserts; ``statistical`` (each member against the
    analytic df, the spread) depends on the run's size."""
    # The members are different models (different seeds)...
    assert results['members_differ']
    # ...and an extracted member reproduces its vmapped work values.
    np.testing.assert_allclose(results['member_0_work'],
                               results['vmapped_work_0'],
                               rtol=1e-9, atol=1e-12)
    if statistical:
        dfs = results['dfs']
        assert np.all(np.abs(dfs - DF_ANALYTIC) < 0.1), (dfs, DF_ANALYTIC)
        assert results['spread'] < 0.05, results['spread']


def main(argv=None):
    args = parse_args(argv, __doc__)
    results = run(args.device, args.workdir)
    print('final per-member losses:', np.round(results['final_losses'], 4))
    print(f'analytic df      = {DF_ANALYTIC:.4f} kT')
    print(f"per-member df    = {np.round(results['dfs'], 4)}")
    print(f"ensemble mean df = {results['df']:.4f} kT  (member spread std "
          f"{results['spread']:.4f})")
    check(results, statistical=True)
    print('ENSEMBLE TFEP OK')


if __name__ == '__main__':
    main()
