#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tfep_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which passes or exits non-zero:

1. Card: requires CUDA, prints the card's name and power limit, turns TF32
   off for matrix products and convolutions.
2. Kernels: builds the Triton spline kernels from this checkout (K1
   forward, K2 backward) and holds them against their plain PyTorch
   version at the bench shape (B=4096, F=96, K=8, float32), on inputs half
   inside and half outside the domain and on the adversarial case of
   ``tests/ops/test_pallas_spline.py``.
3. Slice: the bench configuration of ``bench.py`` built with the port (6
   MAF layers over 96 DOFs, neural spline with 8 bins on [-3, 3], float32,
   batch 4096, AdamW), with random weights from a seed. One no-grad map
   evaluation, the training steps and a forward/inverse round trip. The
   launch counts of K1 and K2 are set to 0 just before and read just after.
4. Times on the card: each kernel and its plain version, K2's copy probe
   (``tfep_tpu_torch/tools/spline_k2_probe.py``: K2's grid, tile and bytes
   without its arithmetic) in turns with K2, the training step, the map
   evaluation, peak memory, and a ``torch.profiler`` breakdown of the
   training step by kind of kernel, with its table.
5. EGNN kernels: ``nvcc`` builds the CUDA kernels K3 (forward), K4
   (forward and tangent) and K5 (backward of K4) from this checkout while
   phases 2-4 run; each is held against its plain PyTorch version in
   float32 at the bench shape of ``benchmarks/cnf_bench.py`` (B=256, n=32,
   F=D=64), at a ragged shape with pairs beyond the cutoff, at F=24, D=10
   and at n=70 (three sender tiles, the last one partial; F=33, D=17), with
   the path (register-tiled or scalar) each of K5's products takes there,
   and K5's registers, spills (the phase fails if it spills) and launch
   configuration (sender tile, weights and gradient sums in shared or
   device memory).
6. CNF slice: ``benchmarks/cnf_bench.py``'s configuration with
   ``pairwise='fused'`` (32 atoms, EGNN dynamics of 4 layers at width 64,
   rk4 with 8 steps, one Hutchinson probe, regularization, checkpointed
   steps, batch 256, AdamW), random weights from a seed. The map and the
   loss gradients against the float64 dense path on the same weights and
   probe; then the counted path (counts of K3/K4/K5 set to 0 just before,
   read just after): one no-grad map evaluation, the training steps, one
   plain evaluation of the field; then a forward/inverse round trip.
7. CNF times: the launch configuration of K3/K4 (warps per block, blocks
   per SM, registers, spills), each EGNN kernel and its plain version, the
   training step (beside the dense path's on the same map), the map
   evaluation, peak memory, and the profiler's breakdown of the step.
8. The Cartesian reference-frame slice: phase 3's MAF over 90 features
   inside the stack that ``CartesianMAFMap`` builds (``PartialFlow`` with
   4 fixed atoms, ``CenteredCentroidFlow`` on the origin atom,
   ``OrientedFlow``, ``PCAWhitenedFlow`` fitted on 5120 frames), 36 atoms
   of a correlated Gaussian around a seeded molecule, batch 4096. K1/K2
   against their plain version at F=90; the map against the float64
   unfused path; the frame's constraints and a translation; the counted
   path and a round trip as in phase 3; K1/K2's times at F=90, the step,
   the map evaluation, peak memory and the profiler's breakdown.
9. The entry point: the port's ``CartesianMAFMap`` on phase 8's
   configuration (40,960 frames in a ``System``, a harmonic potential in
   kcal/mol at 300 K), trained through ``Trainer.fit``. (a) With phase 8's
   untrained weights (``load_state_dict(strict=True)``) the map's forward
   equals phase 8's flow; (b) one step gives phase 8's first loss; (c) two
   epochs with a seeded shuffle, prefetch and checkpoints: K1/K2 counted
   (6/6 per step), finite losses, every step's log rows in the sampler's
   order, fixed atoms bit-identical; (d) a run stopped at step 15 and
   resumed from ``last.ckpt`` logs each sample of epoch 1 once and ends on
   the uninterrupted run's weights. Then the step with and without the
   logger, its device busy time over a profiled window, the host's work per
   step, a checkpoint, peak memory, and phase 8's bare step beside them.
10. The flagship map: the port's ``MixedMAFMap`` at the configuration of
   ``bench.py``'s ``bench_mixed_jax`` (a 32-atom carbon helix chain with
   0.05 A of noise, 40,960 frames in a ``System``, 6 MAF layers, 8 bins,
   batch 4096, float32, phase 9's potential). (a) K1/K2 against their
   plain version at F=30, the width of the map's one standard spline (the
   angles); (b) the Z-matrix equal to the JAX map's (a literal below) and
   the transformer's groups; (c) the float32 kernel path against the
   float64 unfused path on the same weights, on the frames whose float32
   frame rotation and Z-matrix angles are within CONDITION_TOL of
   float64's (the others in float64); (d) one epoch through
   ``Trainer.fit`` with prefetch and a checkpoint, K1/K2 counted at 6/6 per
   step; (e) finite losses and every step's log rows in the sampler's
   order; (f) a round trip. Then the step with and without the logger, its
   device busy time and idle share, the conversion's device time and
   kernels per step, K1/K2's times at F=30 and peak memory.
11. The CNF map: the port's ``ContinuousEGNNMap`` at
   ``benchmarks/cnf_bench.py``'s configuration, with
   ``egnn_kwargs={'pairwise': 'pallas'}`` (the JAX package's name,
   translated to ``'fused'``), on 1,024 frames of ``0.5 N(0, 1)``. (a) With
   phase 6's weights and the map's probe, its forward equals phase 6's
   flow; (b) 4 steps of ``Trainer.fit`` count K4/K5 at 256/128 per step
   (K4 again in the checkpoint's recompute), finite losses; (c) two steps
   on one batch draw different probes; (d) a run stopped after step 2 and
   resumed ends on the uninterrupted run's weights. Then the step time and
   its device busy time.
12. From a trajectory file to Δf, at phase 10's configuration: (a) the
   port's writers write the helix as a PDB with CONECT bonds and its
   40,960 frames as an XTC; (b) the native decoder is built by g++ (the
   phase fails without it) and recovers the same stored integers as the
   pure-Python one on 256 frames, and a DCD of those frames decodes to the
   same bits both ways; (c) ``MixedMAFMap(coordinates_file_path=...,
   topology_file_path=..., lazy_trajectory=True)`` trains one epoch through
   ``Trainer.fit`` (prefetch, checkpoints), K1/K2 at 6/6 per step, its
   first batch, loss and log rows bit-identical to a map on the decoded
   frames in memory; a map rebuilt from the checkpoint rereads the file
   and resumes to the uninterrupted run's weights bit for bit; the step
   with and without the logger, the lazy read per step and the idle share;
   (d) ``estimate_from_logger`` on the card against numpy float64 on the
   same work and resample indices, timed; (e) the identity-map toy of
   ``tests/app/test_biased.py`` drawn on the card: the unbiased and the
   biased intervals bracket the analytic Δf, the unweighted estimate on
   biased frames misses it.
13. The potentials bridge: phase 9's map and weights trained against a
   host engine, ``HarmonicEngine(EnginePotential)`` (phase 9's potential in
   numpy float64, frame by frame, in kJ/mol and nm inside and kcal/mol and
   angstrom outside). (a) On one batch: its energies against the torch
   potential's, the loss gradients through the autograd bridge
   (``-forces * g``) against autograd through the torch potential, and
   the engine's calls (energy only without grad, with forces with it);
   (b) one plain ``Trainer.fit`` step: K1/K2 at 6/6, phase 9's first loss;
   (c) ``Trainer(engine_overlap=True)``: one step against (b)'s weights,
   3 steps against a replay with delayed gradients, two epochs with
   K1/K2 at 12/6 per step and the log rows in the sampler's order, a run
   stopped at step 5 and resumed against the uninterrupted run; (d) a
   ``spawn`` pool of 4 workers made after CUDA: energies and forces
   bit-identical to the serial strategy's, one pipelined step on it;
   (e) with a fixed host latency per batch (phase 9's step without the
   logger): the engine alone, the copies each way, the plain and the
   pipelined step, their device busy time and idle share.
14. Ensembles and bf16 products. (a) ``benchmarks/ensemble_bench.py``'s
   configuration (phase 3's flow, batch 256 shared by the members, AdamW)
   trained as K members stacked by ``stack_modules`` through
   ``make_ensemble_train_step`` (``torch.func.vmap`` of
   ``grad_and_value``), K in 1, 2, 4, 8, 16: K1/K2 launched once per layer
   on the members' rows folded together (6/6 per step at every K), the
   step from CUDA events, member-steps/s, peak memory, the device busy
   share at K=1 and K=16; at K=4 each member's first loss, first
   gradients and weights after 3 steps against the member trained alone;
   the folded K1/K2 against their plain version on the same rows.
   (b) Phase 3's MAF with ``compute_dtype='bfloat16'`` on phase 3's
   weights: y, log_det_J and the loss against float32, 5 counted
   training steps, a round trip, the step, device busy and cuBLAS time
   beside phase 3's float32 ones, the card's bf16 product against the
   exact rule (float32 product of the rounded operands) on the card; then
   ``cnf_bench``'s EGNN field on the dense path with bf16 products against
   float32, without grad.

15. Multi-process training (``parallel/{distributed,sharding}``). (a) One
   rank over NCCL at phase 9's configuration (``CartesianMAFMap``, 90
   features, batch 4096, no logger; weights from the seed): 3 steps of
   ``Trainer(sharding=batch_sharding(make_mesh()))`` against the
   unsharded fit from the same weights, K1/K2 at 6/6 per step, the
   sharded and unsharded step times and the all-reduce's device time
   (profiler). (b) Two ranks that the script spawns on the one card,
   over gloo (NCCL refuses two ranks on one device): (i) data
   parallelism at 2048 rows per rank, 3 steps against one process at
   4096 on the same global batches (losses, first gradients, weights);
   (ii) ``shard_module`` with tp = 2 on phase 3's MAF (MADE 96 → 478 →
   478 → 2400), its forward, gradients and one AdamW step against the
   replicated flow, each rank's weight shapes; (iii) ``shard_ensemble``
   of 4 members of ``ensemble_bench``'s configuration over the 2 ranks, 3
   steps against the unsharded ensemble. (c) ``cnf_bench``'s EGNN field,
   ``pairwise='fused'``, as 2 stacked members: ``forward_and_jvp`` under
   ``ensemble_map`` and its gradient through ``make_ensemble_train_step``
   against each field alone and the plain (dense) version, with the
   K3/K4/K5 launches (one per member and layer).
16. The examples (``tfep_tpu_torch/examples/``), in float64: first K1 and
   K2 in float64 against their plain version at the solvated example's
   shape (B=512, its 36 whitened features, K=8, x on [-8, 8]); then each
   of the seven examples of the JAX package, at its own size, through its
   ``run`` and ``check(statistical=True)`` in this process (the engine
   example spawns its pool of 4), and the port's ``distributed_tfep`` as
   a subprocess (2 gloo ranks sharing the card). Each prints its Δf, its
   interval, the analytic Δf and the margin that must bracket it, its
   steps, its wall seconds and its K1/K2 launches: more than 0 for the
   two examples with spline transformers (solvated, mixed), 0 for the
   others.

The line before the last is one JSON object with each kernel's launches,
error and times; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

B, F, K = 4096, 96, 8
N_LAYERS = 6
N_STEPS = 5
SEED = 0
# Kernel against plain version, float32: |kernel - plain| is held under
# TOL * max(1, max|plain|). Triton's exp, log and division are approximate
# (a few ulp each) over a chain of some fifty dependent operations, and
# autograd of the plain version rounds in another order than K2.
FORWARD_TOL = 1e-4
BACKWARD_TOL = 1e-3
# The slice on the card: the float32 kernel path against the float64
# unfused path ('never') on the same map, six layers deep.
MAP_TOL = 1e-4
# float32 inverse: each of the 96 sequential degree groups hands its
# rounding to the next, six layers deep.
ROUND_TRIP_TOL = 1e-2


def say(*args):
    print(*args, flush=True)


def card_phase():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device is available.')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(smi)
    say('card:', torch.cuda.get_device_name(0), '| TF32 off for matmul and '
        'cuDNN (float32 products run in full float32)')
    return smi


def rel_err(actual, expected):
    """max|actual - expected| and that over max(1, max|expected|)."""
    err = float((actual - expected).abs().max())
    return err, err / max(1.0, float(expected.abs().max()))


def spline_inputs(adversarial, device, seed, f=F):
    """Bench-shape inputs on the domain [-3, 3]; x kept 1e-4 away from
    every knot, where the bin, and so the gradient, is discontinuous."""
    g = torch.Generator().manual_seed(seed)
    bound = torch.ones(f, dtype=torch.float64)
    x0, xf = -3.0 * bound, 3.0 * bound
    if adversarial:
        x = -2.95 + 0.75 * torch.rand(B, f, generator=g, dtype=torch.float64)
        params = torch.zeros(B, (3 * K + 1) * f, dtype=torch.float64)
        params[:, 2 * K * f:] = 9.0
        params[:, (K + 3) * f:(K + 4) * f] = -30.0
        params += 0.1 * torch.randn(params.shape, generator=g,
                                    dtype=torch.float64)
    else:
        # Half the batch inside [-3, 3), half outside (3 <= |x| < 6).
        u = torch.rand(B, f, generator=g, dtype=torch.float64)
        sign = torch.where(torch.rand(B, f, generator=g) < 0.5, -1.0, 1.0)
        x = torch.cat([-3.0 + 6.0 * u[:B // 2],
                       sign[B // 2:] * (3.0 + 3.0 * u[B // 2:])])
        params = 0.5 * torch.randn(B, (3 * K + 1) * f, generator=g,
                                   dtype=torch.float64)
    knots = x0 + torch.cumsum(torch.softmax(
        params.reshape(B, 3 * K + 1, f)[:, :K], dim=1) * (6.0 - K * 1e-4)
        + 1e-4, dim=1)
    knots = torch.cat([x0.expand(B, 1, f), knots], dim=1)
    near = (x[:, None] - knots).abs().min(dim=1).values < 1e-4
    x = torch.where(near, x + 3e-4, x)
    cast = dict(dtype=torch.float32, device=device)
    return (x.to(**cast), params.to(**cast), x0.to(**cast), xf.to(**cast),
            x0.to(**cast), xf.to(**cast))


def kernel_phase(device, f=F):
    """K1 and K2 against the plain version at (B, f, K); returns the
    measured errors."""
    from tfep_tpu_torch.ops import spline as fs
    results = {}
    for case in ('mixed', 'adversarial'):
        x, params, *bounds = spline_inputs(case == 'adversarial', device, 1,
                                           f)
        g = torch.Generator().manual_seed(2)
        gy = torch.randn(B, f, generator=g).to(device)
        gl = torch.randn(B, f, generator=g).to(device)
        outs = {}
        for name, fn in (('kernel', fs.fused_spline),
                         ('plain', fs.fused_spline_reference)):
            xi = x.clone().requires_grad_()
            pi = params.clone().requires_grad_()
            y, dl = fn(xi, pi, *bounds, K)
            gx, gp = torch.autograd.grad((y, dl), (xi, pi), (gy, gl))
            outs[name] = [t.detach() for t in (y, dl, gx, gp)]
        torch.cuda.synchronize()
        for i, label in enumerate(('y', 'dl', 'grad_x', 'grad_params')):
            kern, plain = outs['kernel'][i], outs['plain'][i]
            if not torch.isfinite(kern).all():
                raise AssertionError(f'{case}: kernel {label} not finite')
            err, rel = rel_err(kern, plain)
            tol = FORWARD_TOL if i < 2 else BACKWARD_TOL
            say(f'  {case:11s} {label:11s} max|kernel-plain| = {err:.3e} '
                f'(relative to scale {rel:.3e}, tolerance {tol:g})')
            if not rel <= tol:
                raise AssertionError(f'{case}: {label} disagrees')
            key = 'forward' if i < 2 else 'backward'
            results[key] = max(results.get(key, 0.0), err)
    return results


def kernel_resources(device):
    """Registers and spills per thread of each compiled kernel, as Triton
    reports them for one direct launch at the bench shape."""
    from tfep_tpu_torch.ops import spline as fs
    x, params, *bounds = spline_inputs(False, device, 3)
    consts = fs._constants(x.device, x.dtype, 1e-4, 1e-4)
    y, dl = torch.empty_like(x), torch.empty_like(x)
    forward = fs._kernels()['forward'][fs._grid(B, F)](
        x, params, *bounds, consts, y, dl, B, F, K=K, BLOCK_B=fs.BLOCK_B,
        BLOCK_F=fs.BLOCK_F, num_warps=fs.NUM_WARPS)
    gx, gp = torch.empty_like(x), torch.empty_like(params)
    backward = fs._backward_launch(x, params, bounds, consts, y, dl, gx, gp,
                                   K, fs.BACKWARD_LAYOUT)
    torch.cuda.synchronize()
    tiles = (f'{fs.BLOCK_B}x{fs.BLOCK_F}, {fs.NUM_WARPS} warps',
             '{BLOCK_B}x{BLOCK_F}, {num_warps} warps'.format(
                 **fs.BACKWARD_LAYOUT))
    for name, handle, tile in (('spline_forward', forward, tiles[0]),
                               ('spline_backward', backward, tiles[1])):
        say(f'  {name}: {getattr(handle, "n_regs", "not reported")} '
            f'registers, {getattr(handle, "n_spills", "not reported")} '
            f'spills per thread; block {tile}')


def build_slice(device, seed=SEED, batch=B, compute_dtype=None):
    """The bench configuration with the port's entry points: the flow and
    ``batch`` frames, from ``seed``."""
    from tfep_tpu_torch.nn.conditioners.made import generate_degrees
    from tfep_tpu_torch.nn.flows import MAF, SequentialFlow
    from tfep_tpu_torch.nn.transformers import NeuralSplineTransformer
    generator = torch.Generator().manual_seed(seed)
    bound = np.ones(F)
    layers = [MAF.create(
        generator, generate_degrees(
            F, order='ascending' if i % 2 == 0 else 'descending'),
        transformer=NeuralSplineTransformer(-3.0 * bound, 3.0 * bound, K,
                                            device=device),
        device=device, dtype=torch.float32, compute_dtype=compute_dtype)
        for i in range(N_LAYERS)]
    flow = SequentialFlow.create(*layers, device=device)
    # Random weights: identity initialization zeroes the output gains,
    # which would make every spline the identity.
    with torch.no_grad():
        for p in flow.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=generator).to(p))
    frames = torch.randn(batch, F, generator=generator).to(device)
    return flow, frames


def set_fused(flow, policy):
    """The fused policy of every spline in ``flow``."""
    for module in flow.modules():
        if hasattr(module, 'fused'):
            module.fused = policy


def slice_phase(flow, frames, n_steps, round_trip_frames=None,
                ldj_slack=None, record=None):
    """The map against the float64 unfused path, the counted main path (a
    no-grad evaluation, then the training steps) and a round trip, on the
    frames that ``round_trip_frames`` selects (all by default).
    ``ldj_slack(x, y)``, where given, is each frame's rounding allowance
    on log_det_J besides MAP_TOL. ``record``, where given, receives the
    steps' losses under ``'losses'``."""
    from tfep_tpu_torch.loss import boltzmann_kl_div_loss
    from tfep_tpu_torch.nn.flows import SequentialFlow
    from tfep_tpu_torch.ops.spline import LAUNCHES

    mafs = next(m for m in flow.modules() if isinstance(m, SequentialFlow))
    n_params = sum(p.numel() for p in flow.parameters())
    say(f'  flow: {N_LAYERS} MAF layers, MADE widths '
        f'{mafs[0].conditioner.dimension_in} -> '
        f'{mafs[0].conditioner.dimensions_hidden} -> '
        f'{mafs[0].conditioner.dimension_out}, {n_params} parameters')

    # The kernel path (float32) against the port's unfused path on the
    # same map in float64, which the float32 unfused path is not: it maps
    # out-of-domain inputs through outer bins 1000 domains wide.
    reference = copy.deepcopy(flow).double()
    set_fused(reference, 'never')
    with torch.no_grad():
        y_k, ldj_k = flow(frames)
        y_p, ldj_p = reference(frames.double())
    del reference
    for label, kern, plain in (('y', y_k, y_p), ('log_det_J', ldj_k, ldj_p)):
        slack = (ldj_slack(frames, y_p) if ldj_slack is not None
                 and label == 'log_det_J' else None)
        if not within(label, 'map', 'kernel path - float64 unfused path',
                      kern, plain, slack):
            raise AssertionError(f'map {label} disagrees')

    optimizer = torch.optim.AdamW(flow.parameters(), lr=1e-4,
                                  weight_decay=1e-4, eps=1e-8)

    def train_step():
        optimizer.zero_grad(set_to_none=True)
        y, ldj = flow(frames)
        loss = boltzmann_kl_div_loss(0.5 * torch.sum(y * y, dim=-1), ldj)
        loss.backward()
        optimizer.step()
        return loss

    # The main path, counted.
    LAUNCHES.reset()
    with torch.no_grad():
        y, ldj = flow(frames)
        work = 0.5 * torch.sum(y * y, dim=-1) - ldj
    counts = [(LAUNCHES.forward, LAUNCHES.backward)]
    losses = []
    for _ in range(n_steps):
        losses.append(float(train_step().detach()))
        counts.append((LAUNCHES.forward, LAUNCHES.backward))
    launches = {'forward': LAUNCHES.forward, 'backward': LAUNCHES.backward}
    if record is not None:
        record['losses'] = losses

    if counts[0] != (N_LAYERS, 0):
        raise AssertionError(f'map evaluation launched {counts[0]}')
    for a, b in zip(counts, counts[1:]):
        if (b[0] - a[0], b[1] - a[1]) != (N_LAYERS, N_LAYERS):
            raise AssertionError(f'a training step launched {b} - {a}')
    say(f'  map evaluation: work shape {tuple(work.shape)}, mean '
        f'{float(work.mean()):.6f}; K1/K2 launches {counts[0]}')
    say(f'  {n_steps} training steps, loss {losses}; K1/K2 launches per '
        f'step {N_LAYERS}/{N_LAYERS}; total {launches}')
    if not (torch.isfinite(work).all() and np.all(np.isfinite(losses))):
        raise AssertionError('non-finite work or loss')

    round_trip(flow, frames if round_trip_frames is None
               else frames[round_trip_frames])
    return launches, train_step


def within(label, what, difference, actual, expected, slack=None):
    """Prints max|actual - expected| and whether it is within MAP_TOL of
    max(1, max|expected|), plus each frame's ``slack`` where given."""
    err, rel = rel_err(actual.double(), expected)
    line = (f'  {what} {label}: max|{difference}| = {err:.3e} (relative to '
            f'scale {rel:.3e}, tolerance {MAP_TOL:g}')
    if slack is not None:
        excess = ((actual.double() - expected).abs() - slack).clamp(min=0)
        rel = float(excess.max()) / max(1.0, float(expected.abs().max()))
        line += (f', with each frame\'s rounding allowance (at most '
                 f'{float(slack.max()):.3e}) {rel:.3e}')
    say(line + ')')
    return rel <= MAP_TOL


def round_trip(flow, frames, label='round trip'):
    """inverse(forward(x)) against x, at ROUND_TRIP_TOL."""
    with torch.no_grad():
        y, ldj = flow(frames)
        x_back, ldj_inv = flow.inverse(y)
    rt_err, rt_rel = rel_err(x_back, frames)
    ldj_err = float((ldj + ldj_inv).abs().max())
    say(f'  {label} ({frames.shape[0]} frames, {frames.dtype}): '
        f'max|inverse(forward(x)) - x| = {rt_err:.3e}, '
        f'max|ldj + ldj_inverse| = {ldj_err:.3e} (tolerance '
        f'{ROUND_TRIP_TOL:g} relative to scale)')
    if not (rt_rel <= ROUND_TRIP_TOL and ldj_err <= ROUND_TRIP_TOL *
            max(1.0, float(ldj.abs().max()))):
        raise AssertionError(f'{label} disagrees')


def event_ms(fn, n, sets):
    """Mean ms per call of ``fn(*sets[i % len(sets)])`` from CUDA events,
    after a warm-up; the sets rotate so the inputs exceed the L2 cache.

    Also returns the host's ms per call to enqueue the work: where it comes
    close to the event time, the host and not the card set the pace.
    """
    for i in range(3):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(n):
        fn(*sets[i % len(sets)])
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, host_ms


def graph_ms(fn, sets, n, reps):
    """Device ms per call of ``fn(*sets[i % len(sets)])``: ``n`` calls
    captured in one CUDA graph and replayed ``reps`` times between CUDA
    events, so the host's cost of launching drops out."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in range(3):
            fn(*sets[i % len(sets)])
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*sets[i % len(sets)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def spline_sets(device, f=F):
    """Four input sets of K1/K2 at (B, f, K), 44 MB each at F = 96: more
    than the 50 MB L2 cache together."""
    sets = []
    for seed in range(4):
        x, params, *bounds = spline_inputs(False, device, 10 + seed, f)
        g = torch.Generator().manual_seed(20 + seed)
        gy = torch.randn(B, f, generator=g).to(device)
        gl = torch.randn(B, f, generator=g).to(device)
        sets.append((x, params, bounds, gy, gl))
    return sets


def timing_phase(device, flow, frames, train_step, smi):
    from tfep_tpu_torch.ops import spline as fs
    from tfep_tpu_torch.tools import spline_k2_probe as k2_probe
    sets = spline_sets(device)
    consts = (K, 1e-4, 1e-4)

    def k1(x, params, bounds, gy, gl):
        fs.launch_forward(x, params, *bounds, *consts)

    def k2(x, params, bounds, gy, gl):
        fs.launch_backward(x, params, *bounds, gy, gl, *consts)

    def probe(x, params, bounds, gy, gl):
        k2_probe.launch_probe(x, params, bounds, gy, gl, K,
                              fs.BACKWARD_LAYOUT)

    def plain_fwd(x, params, bounds, gy, gl):
        with torch.no_grad():
            fs.fused_spline_reference(x, params, *bounds, K)

    def plain_fwd_bwd(x, params, bounds, gy, gl):
        xi = x.detach().requires_grad_()
        pi = params.detach().requires_grad_()
        outs = fs.fused_spline_reference(xi, pi, *bounds, K)
        torch.autograd.grad(outs, (xi, pi), (gy, gl))

    rows = []
    plain_fwd_ms = None
    for name, kern, plain, nbytes, nops in (
            ('spline_forward', k1, plain_fwd,
             fs.forward_bytes(B, F, K, 4), fs.forward_ops(B, F, K)),
            ('spline_backward', k2, plain_fwd_bwd,
             fs.backward_bytes(B, F, K, 4), fs.backward_ops(B, F, K))):
        # Kernel and plain version in turns: kernel, plain, plain, kernel.
        k_runs = [graph_ms(kern, sets, 64, 5)]
        p_runs = [graph_ms(plain, sets, 8, 3) for _ in range(2)]
        k_runs.append(graph_ms(kern, sets, 64, 5))
        k_ms, p_ms = sum(k_runs) / 2, sum(p_runs) / 2
        if plain_fwd_ms is None:
            plain_fwd_ms = p_ms
        else:
            # The plain backward: forward and backward less the forward.
            p_ms -= plain_fwd_ms
        eager_ms, host_ms = event_ms(kern, 200, sets)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / FP32_OPS_PER_S * 1e3
        if name == 'spline_backward':
            # K2's copy probe: K2's grid and tile, K2's bytes, no
            # arithmetic; in turns with K2 (probe, K2, K2, probe).
            runs = [graph_ms(probe, sets, 64, 5)]
            k2 = [graph_ms(kern, sets, 64, 5) for _ in range(2)]
            runs.append(graph_ms(probe, sets, 64, 5))
            probe_ms = sum(runs) / 2
            say(f'  spline_backward copy probe (K2\'s grid and tile, '
                f'K2\'s bytes, no arithmetic): {probe_ms:.5f} ms (runs '
                f'{runs[0]:.5f}, {runs[1]:.5f}), '
                f'{100 * bytes_ms / probe_ms:.1f}% of the byte bound; K2 '
                f'beside it {sum(k2) / 2:.5f} ms, '
                f'{sum(k2) / 2 / probe_ms:.3f}x the probe; [{smi}]')
        rows.append(dict(name=name, ms=k_ms, plain_ms=p_ms,
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by='bytes' if bytes_ms >= ops_ms
                         else 'operations',
                         eager_ms=eager_ms))
        say(f'  {name}: {k_ms:.5f} ms on the card (CUDA graph, runs '
            f'{k_runs[0]:.5f}, {k_runs[1]:.5f}); plain version {p_ms:.5f} '
            f'ms; bound {max(bytes_ms, ops_ms):.5f} ms ({nbytes / 1e6:.1f} '
            f'MB at 3.35 TB/s; {nops / 1e6:.0f} Mop at 67 TFLOP/s); eager '
            f'launches back to back {eager_ms:.5f} ms each, host enqueue '
            f'{host_ms:.5f} ms; [{smi}]')
    say('  library call: none (no single PyTorch call computes the '
        'rational-quadratic spline)')
    return rows, step_times(flow, frames, train_step, smi)


def step_times(flow, frames, train_step, smi, n=20):
    """The training step and the map evaluation, host clock around work
    that ends in a synchronize, and the step's peak memory."""
    for _ in range(3):
        train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        train_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        flow(frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            flow(frames)
        torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) / n * 1e3
    batch = frames.shape[0]
    say(f'  training step: {step_ms:.3f} ms, {batch / step_ms * 1e3:.0f} '
        f'frames/s at batch {batch}; peak memory {peak / 2**20:.1f} MiB; '
        f'[{smi}]')
    say(f'  map evaluation (no grad): {eval_ms:.3f} ms, '
        f'{batch / eval_ms * 1e3:.0f} frames/s; [{smi}]')
    return dict(step_ms=step_ms, frames_per_s=batch / step_ms * 1e3,
                eval_ms=eval_ms, peak_bytes=peak)


def _timed_build(build):
    """``(path, seconds)`` of ``build()``, or the exception it raised."""
    t0 = time.perf_counter()
    try:
        return build(), time.perf_counter() - t0
    except BaseException as error:  # re-raised in the main thread
        return error


def kernel_kinds(prof):
    """``{kind: (kernels, us)}``: the device time of a torch.profiler
    profile by kind of kernel."""
    from torch.autograd import DeviceType
    kinds = {}
    for event in prof.events():
        if event.device_type != DeviceType.CUDA:
            continue
        name = event.name.lower()
        if name in ('forward_kernel', 'backward_kernel'):
            kind = 'spline kernels (K1, K2)'
        elif 'egnn_' in name or 'reduce_partials' in name:
            kind = 'EGNN kernels (K3, K4, K5)'
        elif any(s in name for s in ('gemm', 'xmma', 'cutlass', 'sm90_',
                                     'nvjet')):
            kind = 'matrix products (cuBLAS)'
        elif 'multi_tensor' in name or 'adam' in name:
            kind = 'optimizer'
        elif 'memcpy' in name or 'memset' in name:
            kind = 'copies'
        else:
            kind = 'other elementwise and reductions'
        count, us = kinds.get(kind, (0, 0.0))
        kinds[kind] = (count + 1, us + event.time_range.elapsed_us())
    return kinds


def profile_phase(train_step, step_ms, smi, n=5, batch=B, kinds_out=None):
    """Device time of the training step by kernel, from torch.profiler:
    the busy share of the step and the time by kind of kernel (also into
    ``kinds_out``, where given, as ``{kind: (kernels, ms) per step}``)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(min(n, 3)):
        train_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            train_step()
        torch.cuda.synchronize()
    kinds = kernel_kinds(prof)
    busy_ms = sum(us for _, us in kinds.values()) / n / 1e3
    if kinds_out is not None:
        kinds_out.update({kind: (count / n, us / n / 1e3)
                          for kind, (count, us) in kinds.items()})
    lines = [smi, f'training step, batch {batch}, {n} steps profiled; '
             f'unprofiled step {step_ms:.3f} ms']
    if busy_ms == 0.0:
        lines.append('torch.profiler recorded no device time')
    else:
        lines.append(f'device busy {busy_ms:.3f} ms per step, idle share '
                     f'{1.0 - busy_ms / step_ms:.3f} of the unprofiled step')
        for kind, (count, us) in sorted(kinds.items(),
                                        key=lambda kv: -kv[1][1]):
            lines.append(f'  {kind}: {us / n / 1e3:.3f} ms per step, '
                         f'{count / n:.0f} kernels per step')
    say('\n'.join('  ' + line for line in lines))
    say(prof.key_averages().table(sort_by='self_device_time_total',
                                  row_limit=30, max_name_column_width=70))
    return busy_ms


# ---------------------------------------------------------------------------
# The CNF slice: EGNN kernels K3/K4/K5 and the training step of
# benchmarks/cnf_bench.py (--pairwise pallas).
# ---------------------------------------------------------------------------

N_ATOMS, CNF_BATCH, CNF_FEAT, CNF_LAYERS, ODE_STEPS = 32, 256, 64, 4, 8
R_CUTOFF = 6.0
CNF_STEPS = 3
# Each evaluation of the field runs the pairwise block once per layer, and
# rk4 evaluates it 4 times per step.
BLOCKS_PER_PASS = 4 * ODE_STEPS * CNF_LAYERS
# EGNN kernels against their plain version, float32, relative to
# max(1, max|plain|): the products sum 64 terms in another order than
# cuBLAS (forward and tangent); the weight gradients also sum over all
# 262,144 pairs, per frame and then over frames, in another order than
# autograd, through a second-order chain.
EGNN_FORWARD_TOL = 1e-4
EGNN_BACKWARD_TOL = 1e-3
# The CNF slice on the card: the float32 kernel path against the float64
# dense path on the same weights and probe, through 32 evaluations of a
# 4-layer field (float32 rounding carried through the integration).
CNF_MAP_TOL = 1e-4
CNF_GRAD_TOL = 1e-3
# Round trip: forward and inverse each integrate on the fixed rk4 grid of
# 8 steps, so inverse(forward(x)) differs from x by the discretization
# error (ContinuousFlow.inverse); the Hutchinson log-dets cancel only to
# that error.
CNF_ROUND_TRIP_TOL = 1e-2


def egnn_inputs(B, n, F, D, device, seed, spread=0.5):
    """K3/K4/K5 arguments at the scale of an initialized layer, float32:
    the 14 primals, the 3 tangents and the 4 cotangents. ``spread`` is
    the positions' scale (0.5 as the bench's frames: every pair inside
    the cutoff; 4 puts many beyond it)."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, fan_in=1):
        return torch.randn(*shape, generator=g,
                           dtype=torch.float64) / fan_in ** 0.5

    pos = spread * r(B, n, 3)
    diff = pos[:, :, None] - pos[:, None]
    eye = torch.eye(n, dtype=torch.bool)
    dist = torch.sqrt(torch.where(eye, 1.0, (diff ** 2).sum(-1)) + 1e-20)
    weights = [torch.linspace(0, R_CUTOFF, D, dtype=torch.float64),
               0.1 * r(D) + float(np.log(((D - 1) / (3 * R_CUTOFF)) ** 2)),
               r(F, D, fan_in=D), r(F, fan_in=F), r(F, F, fan_in=F),
               r(F, fan_in=F), r(F, fan_in=F), r(1, fan_in=F),
               r(F, F, fan_in=F), r(F, fan_in=F), r(F, fan_in=F)]
    groups = ([r(B, n, F), r(B, n, F), dist] + weights,
              [r(B, n, F), r(B, n, F), r(B, n, n)],
              [r(B, n, F), r(B, n, n), r(B, n, F), r(B, n, n)])
    return [[t.to(dtype=torch.float32, device=device) for t in group]
            for group in groups]


def egnn_kernel_phase(device):
    """K3, K4 and K5 against their plain version; returns the largest
    error of each at the bench shape."""
    from tfep_tpu_torch.ops import egnn as E
    names = ('a_i', 'a_j', 'dist') + E.WEIGHTS + ('da_i', 'da_j', 'dd')
    errors = {}
    ptxas = E.ptxas_report()
    for dtype, torch_dtype in (('float', torch.float32),
                               ('double', torch.float64)):
        (k5,) = [v for k, v in ptxas.items()
                 if f'egnn_kernelI{dtype[0]}E' in k]
        cfg = E.k5_config(torch_dtype, CNF_FEAT, CNF_FEAT, device)
        say(f'  K5 egnn_kernel<{dtype}>: {k5["registers"]} registers, '
            f'{k5["spill_store_bytes"]} bytes of spill stores, '
            f'{k5["spill_load_bytes"]} of spill loads, {k5["stack_bytes"]} '
            'bytes of stack per thread (ptxas); at F=D=64 a sender tile of '
            f'{cfg["pt"]} pairs, weights in '
            f'{"shared" if cfg["w_smem"] else "device"} memory, gradient '
            f'sums in {"shared" if cfg["g_smem"] else "device"} memory, '
            f'{cfg["smem_bytes"]} bytes of shared memory per block')
        if k5['spill_store_bytes'] or k5['spill_load_bytes']:
            raise AssertionError(f'K5 egnn_kernel<{dtype}> spills')
    say(f'  tolerances: forward and tangent {EGNN_FORWARD_TOL:g}, '
        f'gradients {EGNN_BACKWARD_TOL:g}, relative to max(1, max|plain|) '
        '(float32 sums of 64 products in another order; the weight '
        'gradients sum over every pair of the batch)')
    for shape, spread in (((CNF_BATCH, N_ATOMS, CNF_FEAT, CNF_FEAT), 0.5),
                          ((7, 13, CNF_FEAT, CNF_FEAT), 4.0),
                          ((5, 9, 24, 10), 4.0),
                          ((3, 70, 33, 17), 4.0)):
        paths = E.k5_product_paths(*shape[2:])
        say(f'  B,n,F,D={shape}: K5 products (float32, weights in shared '
            'memory): ' + ', '.join(f'{k} {v}' for k, v in paths.items()))
        primals, tangents, cots = egnn_inputs(*shape, device, 5, spread)
        with torch.no_grad():
            k3 = E.egnn_pairwise(*primals, R_CUTOFF)
            p3 = E.pairwise_reference(*primals, R_CUTOFF)
        results = {}
        for name, fn in (('kernel', E.egnn_pairwise_jvp),
                         ('plain', E.pairwise_jvp_reference)):
            args = [t.clone().requires_grad_() for t in primals + tangents]
            outs = fn(*args, R_CUTOFF)
            grads = torch.autograd.grad(outs, args, cots)
            results[name] = ([o.detach() for o in outs], grads)
        torch.cuda.synchronize()
        checks = [('K3', f'K3 {n_}', a, b, EGNN_FORWARD_TOL)
                  for n_, a, b in zip(('nm', 'mag'), k3, p3)]
        checks += [('K4', f'K4 {n_}', a, b, EGNN_FORWARD_TOL) for n_, a, b in
                   zip(('nm', 'mag', 'dnm', 'dmag'), results['kernel'][0],
                       results['plain'][0])]
        checks += [('K5', f'K5 grad {n_}', a, b, EGNN_BACKWARD_TOL)
                   for n_, a, b in zip(names, results['kernel'][1],
                                       results['plain'][1])]
        worst = {}
        for kernel, label, kern, plain, tol in checks:
            if not torch.isfinite(kern).all():
                raise AssertionError(f'{shape}: {label} not finite')
            err, rel = rel_err(kern, plain)
            if not rel <= tol:
                raise AssertionError(f'{shape}: {label} disagrees: '
                                     f'{err:.3e} ({rel:.3e} relative)')
            if rel >= worst.get(kernel, (0.0, 0.0, ''))[1]:
                worst[kernel] = (err, rel, label)
            if shape[0] == CNF_BATCH:
                errors[kernel] = max(errors.get(kernel, 0.0), err)
        for kernel, (err, rel, label) in worst.items():
            say(f'  B,n,F,D={shape}: {kernel} worst {label}: '
                f'max|kernel-plain| = {err:.3e} (relative {rel:.3e})')
    return errors


def build_cnf(device, dtype=torch.float32):
    """cnf_bench's configuration with the port's entry points, weights
    and frames from the seed; pairwise='fused'."""
    from tfep_tpu_torch.nn.dynamics import EGNNDynamics
    from tfep_tpu_torch.nn.flows import ContinuousFlow
    generator = torch.Generator().manual_seed(SEED)
    dynamics = EGNNDynamics.create(
        generator, node_types=np.arange(N_ATOMS) % 4, r_cutoff=R_CUTOFF,
        time_feat_dim=16, node_feat_dim=CNF_FEAT,
        distance_feat_dim=CNF_FEAT, n_layers=CNF_LAYERS,
        initialize_identity=False, device=device, dtype=dtype,
        pairwise='fused')
    flow = ContinuousFlow.create(
        dynamics, trace_estimator='hutchinson', solver='rk4',
        n_steps=ODE_STEPS, regularization=True, checkpoint=True,
        device=device)
    frames = 0.5 * torch.randn(CNF_BATCH, 3 * N_ATOMS, generator=generator)
    return flow, frames.to(device=device, dtype=dtype)


def dense_copy(flow):
    """The same map in float64 through the dense pairwise formulation."""
    reference = copy.deepcopy(flow).double()
    for layer in reference.dynamics.graph_layers:
        layer.pairwise = 'dense'
    return reference


def cnf_loss(y, ldj, reg):
    return (torch.mean(0.5 * torch.sum(y * y, dim=-1) - ldj)
            + 0.01 * torch.mean(reg))


def cnf_phase(flow, frames):
    from tfep_tpu_torch.ops.egnn import LAUNCHES
    n_params = sum(p.numel() for p in flow.parameters())
    say(f'  flow: ContinuousFlow(EGNNDynamics), {N_ATOMS} atoms, '
        f'{CNF_LAYERS} layers, feat {CNF_FEAT}, rk4 x {ODE_STEPS}, batch '
        f'{CNF_BATCH}, pairwise=fused, {n_params} parameters')
    eps = flow.probes(frames)
    reference = dense_copy(flow)

    # The map and the loss gradients against the float64 dense path.
    with torch.no_grad():
        outs_k = flow.integrate(frames, eps)
        outs_p = reference.integrate(frames.double(), eps.double())
    for label, kern, plain in zip(('y', 'log_det_J', 'reg'), outs_k,
                                  outs_p):
        err, rel = rel_err(kern.double(), plain)
        say(f'  map {label}: max|fused float32 - dense float64| = {err:.3e} '
            f'(relative {rel:.3e}, tolerance {CNF_MAP_TOL:g})')
        if not rel <= CNF_MAP_TOL:
            raise AssertionError(f'CNF map {label} disagrees')
    grads = []
    for net, x, e in ((flow, frames, eps),
                      (reference, frames.double(), eps.double())):
        loss = cnf_loss(*net.integrate(x, e))
        params = [p for p in net.parameters() if p.numel()]
        grads.append(torch.autograd.grad(loss, params, allow_unused=True))
    del reference
    worst = (0.0, 0.0, '')
    names = [n for n, p in flow.named_parameters() if p.numel()]
    for name, kern, plain in zip(names, *grads):
        if kern is None or plain is None:
            if (kern is None) != (plain is None):
                raise AssertionError(f'gradient of {name}: one side None')
            continue
        err, rel = rel_err(kern.double(), plain)
        if not (torch.isfinite(kern).all() and rel <= CNF_GRAD_TOL):
            raise AssertionError(f'gradient of {name} disagrees: {err:.3e} '
                                 f'({rel:.3e} relative)')
        worst = max(worst, (rel, err, name))
    say(f'  loss gradients: worst {worst[2]}: max|fused float32 - dense '
        f'float64| = {worst[1]:.3e} (relative {worst[0]:.3e}, tolerance '
        f'{CNF_GRAD_TOL:g})')

    optimizer = torch.optim.AdamW(flow.parameters(), lr=1e-4,
                                  weight_decay=1e-4, eps=1e-8)

    def train_step():
        optimizer.zero_grad(set_to_none=True)
        loss = cnf_loss(*flow(frames))
        loss.backward()
        optimizer.step()
        return loss

    # The main path, counted: a map evaluation, the training steps, and a
    # plain evaluation of the velocity field.
    def counts():
        return (LAUNCHES.k3, LAUNCHES.k4, LAUNCHES.k5)

    LAUNCHES.reset()
    with torch.no_grad():
        y, ldj, reg = flow(frames)
    steps = [counts()]
    losses = []
    for _ in range(CNF_STEPS):
        losses.append(float(train_step().detach()))
        steps.append(counts())
    with torch.no_grad():
        velocity = flow.dynamics(0.5, frames)
    steps.append(counts())
    launches = dict(zip(('k3', 'k4', 'k5'), counts()))

    if steps[0] != (0, BLOCKS_PER_PASS, 0):
        raise AssertionError(f'map evaluation launched {steps[0]}')
    for a, b in zip(steps[:-2], steps[1:-1]):
        delta = tuple(x1 - x0 for x0, x1 in zip(a, b))
        if delta != (0, 2 * BLOCKS_PER_PASS, BLOCKS_PER_PASS):
            raise AssertionError(f'a training step launched {delta}')
    delta = tuple(x1 - x0 for x0, x1 in zip(steps[-2], steps[-1]))
    if delta != (CNF_LAYERS, 0, 0):
        raise AssertionError(f'the plain field launched {delta}')
    say(f'  map evaluation: y {tuple(y.shape)}, ldj mean '
        f'{float(ldj.mean()):.6f}, reg mean {float(reg.mean()):.6f}; '
        f'K3/K4/K5 launches {steps[0]}')
    say(f'  {CNF_STEPS} training steps, loss {losses}; K3/K4/K5 per step '
        f'0/{2 * BLOCKS_PER_PASS}/{BLOCKS_PER_PASS} ({BLOCKS_PER_PASS} K4 '
        f'forward, {BLOCKS_PER_PASS} recomputed under checkpoint)')
    say(f'  plain field dynamics(t, x): {tuple(velocity.shape)}, '
        f'{CNF_LAYERS} K3; total {launches}')
    if not (all(torch.isfinite(t).all() for t in (y, ldj, reg, velocity))
            and np.all(np.isfinite(losses))):
        raise AssertionError('non-finite map, field or loss')

    with torch.no_grad():
        y, ldj, _ = flow.integrate(frames, eps)
        x_back, ldj_inv, _ = flow.integrate(y, eps, inverse=True)
    rt_err, rt_rel = rel_err(x_back, frames)
    ldj_err = float((ldj + ldj_inv).abs().max())
    ldj_rel = ldj_err / max(1.0, float(ldj.abs().max()))
    say(f'  round trip: max|inverse(forward(x)) - x| = {rt_err:.3e}, '
        f'max|ldj + ldj_inverse| = {ldj_err:.3e} (relative {ldj_rel:.3e}; '
        f'tolerance {CNF_ROUND_TRIP_TOL:g}, rk4 with {ODE_STEPS} steps)')
    if not (rt_rel <= CNF_ROUND_TRIP_TOL and ldj_rel <= CNF_ROUND_TRIP_TOL):
        raise AssertionError('CNF round trip disagrees')
    return launches, train_step


def egnn_timing_phase(device, smi):
    """Each EGNN kernel and its plain version at the bench shape."""
    from tfep_tpu_torch.ops import egnn as E
    B, n, F, D = CNF_BATCH, N_ATOMS, CNF_FEAT, CNF_FEAT
    ptxas = E.ptxas_report()
    for label, tangent in (('K3', False), ('K4', True)):
        cfg = E.forward_config(torch.float32, tangent, B, n, F, D, device)
        (spills,) = [v for k, v in ptxas.items()
                     if f'egnn_fwd_kernelIfLb{int(tangent)}' in k]
        say(f'  {label} egnn_fwd_kernel<float, {str(tangent).lower()}>: '
            f'{spills["registers"]} registers, {spills["spill_store_bytes"]} '
            f'bytes of spill stores, {spills["stack_bytes"]} bytes of stack '
            f'per thread (ptxas); {cfg["warps_per_block"]} warps per block, '
            f'{cfg["blocks_per_sm"]} blocks per SM (occupancy API), '
            f'{cfg["smem_bytes"]} bytes of shared memory per block, grid '
            f'{cfg["grid"]}')
        if spills['spill_store_bytes']:
            raise AssertionError(f'{label}: the forward kernel spills')
    sets = [egnn_inputs(B, n, F, D, device, 30 + s) for s in range(2)]
    # (primals, tangents, cotangents) per set.

    def k3(p, t_, c):
        E.launch_k3(*p, r_cutoff=R_CUTOFF)

    def k4(p, t_, c):
        E.launch_k4(*p, *t_, r_cutoff=R_CUTOFF)

    def k5(p, t_, c):
        E.launch_k5(*p, *t_, *c, r_cutoff=R_CUTOFF)

    def plain3(p, t_, c):
        with torch.no_grad():
            E.pairwise_reference(*p, R_CUTOFF)

    def plain4(p, t_, c):
        with torch.no_grad():
            E.pairwise_jvp_reference(*p, *t_, R_CUTOFF)

    def plain5(p, t_, c):
        with torch.no_grad():
            E.pairwise_jvp_backward_reference(*p, *t_, R_CUTOFF, *c)

    rows = []
    for name, kern, plain, nbytes, nops, reps in (
            ('egnn_forward', k3, plain3, E.k3_bytes(B, n, F, D, 4),
             E.k3_ops(B, n, F, D), 8),
            ('egnn_jvp', k4, plain4, E.k4_bytes(B, n, F, D, 4),
             E.k4_ops(B, n, F, D), 4),
            ('egnn_jvp_backward', k5, plain5, E.k5_bytes(B, n, F, D, 4),
             E.k5_ops(B, n, F, D), 2)):
        # Kernel and plain version in turns: kernel, plain, plain, kernel.
        k_runs = [graph_ms(kern, sets, reps, 3)]
        p_runs = [graph_ms(plain, sets, 2, 2) for _ in range(2)]
        k_runs.append(graph_ms(kern, sets, reps, 3))
        k_ms, p_ms = sum(k_runs) / 2, sum(p_runs) / 2
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / FP32_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        rows.append(dict(name=name, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                         bound_by='bytes' if bytes_ms >= ops_ms
                         else 'operations'))
        say(f'  {name}: {k_ms:.4f} ms on the card (CUDA graph, runs '
            f'{k_runs[0]:.4f}, {k_runs[1]:.4f}); plain version {p_ms:.4f} '
            f'ms; bound {bound:.4f} ms ({nops / 1e9:.3f} GFLOP at 67 TFLOP/s; '
            f'{nbytes / 1e6:.1f} MB at 3.35 TB/s); {bound / k_ms:.3f} of '
            f'the bound; [{smi}]')
    say('  library call: none (no single PyTorch call computes the EGNN '
        'pairwise block)')
    return rows


def cnf_timing_phase(flow, frames, train_step, smi):
    """The CNF training step, the no-grad map evaluation, peak memory,
    and the float32 dense path's step on the same map for comparison."""
    def timed(fn, n):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    torch.cuda.reset_peak_memory_stats()
    step_ms = timed(train_step, 3)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        eval_ms = timed(lambda: flow(frames), 3)
    dense = copy.deepcopy(flow)
    for layer in dense.dynamics.graph_layers:
        layer.pairwise = 'dense'
    dense_opt = torch.optim.AdamW(dense.parameters(), lr=1e-4,
                                  weight_decay=1e-4, eps=1e-8)

    def dense_step():
        dense_opt.zero_grad(set_to_none=True)
        cnf_loss(*dense(frames)).backward()
        dense_opt.step()

    torch.cuda.reset_peak_memory_stats()
    dense_ms = timed(dense_step, 2)
    dense_peak = torch.cuda.max_memory_allocated()
    del dense, dense_opt
    say(f'  training step (fused): {step_ms:.2f} ms, '
        f'{CNF_BATCH / step_ms * 1e3:.1f} frames/s at batch {CNF_BATCH}; '
        f'peak memory {peak / 2**20:.1f} MiB; [{smi}]')
    say(f'  map evaluation (no grad, fused): {eval_ms:.2f} ms, '
        f'{CNF_BATCH / eval_ms * 1e3:.1f} frames/s; [{smi}]')
    say(f'  training step (dense, float32, same map): {dense_ms:.2f} ms, '
        f'{CNF_BATCH / dense_ms * 1e3:.1f} frames/s; peak memory '
        f'{dense_peak / 2**20:.1f} MiB; [{smi}]')
    return dict(step_ms=step_ms, frames_per_s=CNF_BATCH / step_ms * 1e3,
                eval_ms=eval_ms, peak_bytes=peak, dense_step_ms=dense_ms,
                dense_peak_bytes=dense_peak)


# ---------------------------------------------------------------------------
# The Cartesian reference-frame slice: the bench MAF inside the flow stack
# that CartesianMAFMap builds, with K1/K2 at F = 90.
# ---------------------------------------------------------------------------

# Atom 0 is the origin (a conditioning atom), atoms 1 and 2 the axes atoms,
# atoms 1-31 mapped, the last four a fixed solvent shell.
CART_ATOMS, CART_SOLVENT = 36, 4
CART_DOFS = 3 * CART_ATOMS
# The MAF sees the 96 DOFs of the 32 unfixed atoms less the six that fix
# the frame: origin xyz, axis atom xy, plane atom y.
CART_F = 3 * (CART_ATOMS - CART_SOLVENT) - 6
# CartesianMAFMap's pca_n_frames default.
CART_PCA_FRAMES = 5120
CART_SHIFT = (1.5, -2.0, 0.75)
# The origin atom goes out and back through one float32 translation:
# |y - x| under a few ulp of max(1, max|x|).
ORIGIN_TOL = 1e-6
# Sines of the angles that the frame constraints keep at zero, in float32:
# the rotations come from arccos/arcsin of a cosine with a few ulp of
# rounding, an angle error of at most about sqrt(2 * 4 * 6e-8) = 7e-4
# (reached where the axis atom lies within 1e-4 rad of the axis, or the
# plane atom's projection within 1e-4 rad of the plane normal).
FRAME_TOL = 1e-3
# That float32 rotation (arccos/arcsin of clipped cosines, as in the JAX
# package) is ill-conditioned where the axis atom nears the z axis or the
# plane atom's projection nears the plane normal: there it is off its
# float64 value by up to about 1e-4, and the float32 inverse of six MAF
# layers amplifies such an input error about a thousandfold. The float32
# round trip is held on the frames whose float32 rotation is within
# ROTATION_TOL of float64's (typically 1e-7 off), the others in float64 on
# the same map.
ROTATION_TOL = 1e-6
# OrientedFlow's frame volume element, 2 log|a| + log|p| of the input and
# of the output (a: the axis atom's distance from the origin atom, p: the
# plane atom's from the axis), turns a rounding delta of a or p into
# delta * (2/|a| + 1/|p|) of log_det_J: about 1e-3 where the MAF maps the
# axis atom next to the origin (|a| ~ 1e-3). log_det_J is held at MAP_TOL
# plus RADIUS_ROUNDING times that sensitivity for each frame; delta is
# about ten float32 ulp of the largest coordinates (about 10).
RADIUS_ROUNDING = 1e-5


def cartesian_frames(n):
    """(n, 108) float64 frames: a correlated anisotropic Gaussian around a
    seeded molecule of 32 atoms in a shell of 4, made as
    examples/solvated_preflow_tfep.py:43-58 makes its state A."""
    rng = np.random.default_rng(SEED)
    n_mol = CART_ATOMS - CART_SOLVENT
    mean = np.concatenate([rng.normal(0.0, 1.2, size=(n_mol, 3)),
                           3.0 * rng.normal(0.0, 1.0, size=(CART_SOLVENT, 3))
                           ]).reshape(-1)
    mixing = np.eye(CART_DOFS) + 0.25 * rng.normal(size=(CART_DOFS,
                                                          CART_DOFS))
    chol = np.linalg.cholesky(0.15 * mixing @ mixing.T)
    return mean + rng.normal(size=(n, CART_DOFS)) @ chol.T


def build_cartesian(device, batch=B, n_pca=CART_PCA_FRAMES):
    """The stack CartesianMAFMap builds with origin_atom=0, axes_atoms=[1,
    2], conditioning_atoms=[0], pca_whitening=True and atoms 32-35 fixed,
    built by hand with the port's flows (the app layer is not ported):
    configure_flow and _wrap_reference_frame of
    tfep_tpu/app/cartesianmaf.py:109-173, the PCA frames as
    _collect_maf_inputs takes them (:175-217), and create_partial_flow of
    tfep_tpu/app/base.py:233-241."""
    from tfep_tpu_torch.nn.conditioners.made import generate_degrees
    from tfep_tpu_torch.nn.flows import (
        MAF, CenteredCentroidFlow, Flow, OrientedFlow, PartialFlow,
        PCAWhitenedFlow, SequentialFlow,
    )
    from tfep_tpu_torch.nn.transformers import NeuralSplineTransformer
    from tfep_tpu_torch.utils.misc import atom_to_flattened_indices

    n_free = 3 * (CART_ATOMS - CART_SOLVENT)

    def wrap(flow, dtype):
        # The axes atoms 1 and 2 are 0 and 1 once the origin atom is out.
        flow = OrientedFlow.create(
            flow, n_features=n_free - 3, axis_point_idx=0, plane_point_idx=1,
            axis='z', plane='xz', device=device, dtype=dtype)
        flow = CenteredCentroidFlow.create(
            flow, space_dimension=3, n_features=n_free,
            subset_point_indices=[0], device=device, dtype=dtype)
        return PartialFlow.create(
            flow, atom_to_flattened_indices(
                np.arange(CART_ATOMS - CART_SOLVENT, CART_ATOMS)),
            n_features=CART_DOFS, device=device)

    class Capture(Flow):
        """The identity, keeping the frames as the MAF stack sees them."""

        def __init__(self):
            super().__init__()
            self.captured = []

        def forward(self, x):
            self.captured.append(x)
            return x, torch.zeros_like(x[:, 0])

    generator = torch.Generator().manual_seed(SEED)
    bound = np.ones(CART_F)
    # The origin atom is the only conditioning atom and leaves with the
    # frame, so the MAF has no conditioning features.
    mafs = SequentialFlow.create(*[MAF.create(
        generator, generate_degrees(
            CART_F, order='ascending' if i % 2 == 0 else 'descending'),
        transformer=NeuralSplineTransformer(-3.0 * bound, 3.0 * bound, K,
                                            device=device),
        device=device, dtype=torch.float32) for i in range(N_LAYERS)],
        device=device)
    with torch.no_grad():
        for p in mafs.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=generator).to(p))

    frames = torch.from_numpy(cartesian_frames(max(n_pca, batch))).to(device)
    capture = Capture()
    probe = wrap(capture, torch.float64)
    with torch.no_grad():
        for start in range(0, n_pca, 1024):
            probe(frames[start:min(start + 1024, n_pca)])
    pca = PCAWhitenedFlow.create(mafs, torch.cat(capture.captured),
                                 device=device)
    say(f'  PCA fit on {n_pca} frames in float64: singular values '
        f'{float(pca.blackening_matrix.norm(dim=1).min()):.4g} to '
        f'{float(pca.blackening_matrix.norm(dim=1).max()):.4g}')
    return wrap(pca, torch.float32), frames[:batch].float()


def radius_slack(x, y):
    """Each frame's rounding allowance on log_det_J: RADIUS_ROUNDING times
    the volume element's sensitivity 2/|a| + 1/|p|, input and output."""
    sensitivity = 0.0
    for z in (x, y):
        atoms = z.double().reshape(z.shape[0], -1, 3)
        axis, plane = atoms[:, 1] - atoms[:, 0], atoms[:, 2] - atoms[:, 0]
        a = axis.norm(dim=1)
        p = torch.linalg.cross(axis, plane).norm(dim=1) / a
        sensitivity = sensitivity + 2.0 / a + 1.0 / p
    return RADIUS_ROUNDING * sensitivity


def frame_phase(flow, frames):
    """The frame's constraints and the translation check on the float32
    kernel path."""
    batch = frames.shape[0]
    shift = torch.tensor(CART_SHIFT, device=frames.device)
    with torch.no_grad():
        y, ldj = flow(frames)
        y_s, ldj_s = flow((frames.reshape(batch, -1, 3) + shift).reshape(
            batch, -1))
    n_mol = 3 * (CART_ATOMS - CART_SOLVENT)
    if not torch.equal(y[:, n_mol:], frames[:, n_mol:]):
        raise AssertionError('a fixed atom moved')
    x_atoms = frames.double().reshape(batch, -1, 3)
    y_atoms = y.double().reshape(batch, -1, 3)
    _, origin_rel = rel_err(y_atoms[:, 0], x_atoms[:, 0])
    axis_in = x_atoms[:, 1] - x_atoms[:, 0]
    axis_out = y_atoms[:, 1] - y_atoms[:, 0]
    normal = torch.linalg.cross(axis_out, x_atoms[:, 2] - x_atoms[:, 0])
    plane_out = y_atoms[:, 2] - y_atoms[:, 0]
    axis_sin = (torch.linalg.cross(axis_in, axis_out).norm(dim=1)
                / (axis_in.norm(dim=1) * axis_out.norm(dim=1)))
    plane_cos = ((plane_out * normal).sum(dim=1).abs()
                 / (plane_out.norm(dim=1) * normal.norm(dim=1)))
    say(f'  fixed atoms {CART_ATOMS - CART_SOLVENT}-{CART_ATOMS - 1} '
        f'bit-identical; origin atom |y - x| {origin_rel:.3e} relative to '
        f'scale (tolerance {ORIGIN_TOL:g})')
    say(f'  axis atom off its input direction from the origin: sine at most '
        f'{float(axis_sin.max()):.3e} (median {float(axis_sin.median()):.3e}); '
        f'plane atom off its input plane: sine at most '
        f'{float(plane_cos.max()):.3e} (median '
        f'{float(plane_cos.median()):.3e}); tolerance {FRAME_TOL:g}')
    if not origin_rel <= ORIGIN_TOL:
        raise AssertionError('the origin atom moved')
    if not (axis_sin.max() <= FRAME_TOL and plane_cos.max() <= FRAME_TOL):
        raise AssertionError('the frame constraints do not hold')
    # The float32 rounding of x + shift goes through the map as in the
    # MAP_TOL check.
    moved = (y.reshape(batch, -1, 3) + shift).reshape(batch, -1)
    what = f'frames translated by {CART_SHIFT}:'
    if not (within('y', what, 'map(x + v) - (map(x) + v)', y_s, moved)
            and within('log_det_J', what, 'change', ldj_s, ldj,
                       radius_slack(frames, y))):
        raise AssertionError('the map does not commute with translations')


def rotation_error(frames):
    """Per frame, max|R32 - R64| of the rotation that OrientedFlow takes
    for it (axis atom 1 onto z, plane atom 2 onto xz, about atom 0)."""
    from tfep_tpu_torch.utils.geometry import reference_frame_rotation_matrix
    atoms = frames.double().reshape(frames.shape[0], -1, 3)
    from_origin = atoms[:, 1:3] - atoms[:, :1]
    r32, r64 = (reference_frame_rotation_matrix(
        from_origin[:, 0].to(dtype), from_origin[:, 1].to(dtype),
        axis=(0.0, 0.0, 1.0), plane_axis=(1.0, 0.0, 0.0))
        for dtype in (torch.float32, torch.float64))
    return (r32.double() - r64).abs().amax(dim=(1, 2))


def cartesian_phase(device, smi, handoff=None):
    """Phase 8: K1/K2 at F = 90, the stack, its checks, times, profile.

    ``handoff``, where given, receives what phase 9 holds the app layer
    against: the weights before training (``state``), the frames, the
    untrained map on them (``y``, ``log_det_J``), the first step's loss
    and the step's device busy time."""
    from tfep_tpu_torch.ops import spline as fs
    errors = kernel_phase(device, CART_F)
    flow, frames = build_cartesian(device)
    if handoff is not None:
        with torch.no_grad():
            y, ldj = flow(frames)
        handoff.update(state={k: v.detach().clone()
                              for k, v in flow.state_dict().items()},
                       frames=frames, y=y, log_det_J=ldj)
    frame_phase(flow, frames)
    rotation_err = rotation_error(frames)
    conditioned = rotation_err <= ROTATION_TOL
    say(f'  {int((~conditioned).sum())} of {frames.shape[0]} frames take a '
        f'float32 frame rotation more than {ROTATION_TOL:g} off float64\'s '
        f'(at most {float(rotation_err.max()):.3e})')
    record = {}
    launches, train_step = slice_phase(flow, frames, N_STEPS, conditioned,
                                       radius_slack, record)
    reference = copy.deepcopy(flow).double()
    set_fused(reference, 'never')
    round_trip(reference, frames[~conditioned].double(),
               'round trip of the other frames')
    del reference

    sets = spline_sets(device, CART_F)
    consts = (K, 1e-4, 1e-4)
    kernel_ms = {}
    for name, launch, nbytes, nops in (
            ('spline_forward',
             lambda x, p, b, gy, gl: fs.launch_forward(x, p, *b, *consts),
             fs.forward_bytes(B, CART_F, K, 4), fs.forward_ops(B, CART_F, K)),
            ('spline_backward',
             lambda x, p, b, gy, gl: fs.launch_backward(x, p, *b, gy, gl,
                                                        *consts),
             fs.backward_bytes(B, CART_F, K, 4),
             fs.backward_ops(B, CART_F, K))):
        runs = [graph_ms(launch, sets, 64, 5) for _ in range(2)]
        kernel_ms[name] = sum(runs) / 2
        bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3
        say(f'  {name} at F={CART_F}: {kernel_ms[name]:.5f} ms (CUDA graph, '
            f'runs {runs[0]:.5f}, {runs[1]:.5f}); bound {bound_ms:.5f} ms '
            f'({nbytes / 1e6:.1f} MB); [{smi}]')
    del sets
    times = step_times(flow, frames, train_step, smi)
    busy_ms = profile_phase(train_step, times['step_ms'], smi)
    if handoff is not None:
        handoff.update(first_loss=record['losses'][0], busy_ms=busy_ms)
    return dict(errors=errors, launches=launches, kernel_ms=kernel_ms,
                **times)


# ---------------------------------------------------------------------------
# Phase 9: the app layer, the entry point users call. The port's
# CartesianMAFMap on phase 8's configuration, trained through Trainer.fit.
# ---------------------------------------------------------------------------

# 10 batches of 4096 frames.
APP_FRAMES = 10 * B
APP_EPOCHS = 2
APP_STEPS = APP_EPOCHS * APP_FRAMES // B
APP_CRASH_STEP = 15
# Trainer.fit's steps between the two unprofiled runs whose difference
# times a step (set-up, first steps and the end cancel out).
APP_TIMED_STEPS = 20
# The map against phase 8's hand-built stack on the same weights and
# frames: the same modules and kernels in the same order, so the two agree
# bit for bit; a difference under this fraction of max(1, max|y|) is
# reported, not failed.
APP_MAP_TOL = 1e-6
# The first loss: the map reduces u = 0.5 kT |y|^2 by kT, where the
# hand-built step takes 0.5 |y|^2 directly; the product and the quotient
# round twice more in float32 (a few 1e-7 relative per frame).
APP_LOSS_TOL = 1e-5
# The resumed run replays the uninterrupted run's batches from its
# checkpointed weights and Adam moments with the same float32 operations
# in the same order, so its weights should equal it bit for bit. A
# library's reduction that adds in another order on the second run would
# change a gradient by about 1e-7 relative, and an Adam step by less than
# lr = 1e-4 times that; 1e-6 absolute (the weights are about 0.05 to 2)
# leaves room for that over 5 steps and fails on any real difference
# (a replayed or skipped batch moves the weights by about lr = 1e-4).
APP_RESUME_TOL = 1e-6


class HarmonicPotential:
    """u(y) = 0.5 kT |y|^2 in kcal/mol at 300 K: reduced by kT, phase 8's
    0.5 |y|^2."""

    def __init__(self):
        from tfep_tpu_torch.units import ureg
        self.energy_unit = ureg.kilocalorie_per_mole
        self.kT = float(ureg.kT(300.0 * ureg.kelvin,
                                self.energy_unit).magnitude)

    def __call__(self, x, cell=None):
        return 0.5 * self.kT * torch.sum(x * x, dim=-1)


def app_orders(seed, n_epochs):
    """The dataset indices of each step, as the trainer's sampler draws
    them for ``shuffle_seed=seed``."""
    from tfep_tpu_torch.io.sampler import StatefulBatchSampler

    class Clock:
        global_step = 0

    sampler = StatefulBatchSampler(range(APP_FRAMES), batch_size=B,
                                   shuffle=True, trainer=Clock(),
                                   shuffle_seed=seed)
    steps = []
    for _ in range(n_epochs):
        steps.extend(sampler)
        Clock.global_step += len(sampler)
    return steps


def app_topology():
    """The 32-atom molecule in its 4-atom shell."""
    from tfep_tpu_torch.io.topology import Topology

    n_mol = CART_ATOMS - CART_SOLVENT
    return Topology(
        names=[f'C{i}' for i in range(n_mol)] + ['OW'] * CART_SOLVENT,
        resnames=['MOL'] * n_mol + ['SOL'] * CART_SOLVENT,
        resids=[1] * n_mol + list(range(2, 2 + CART_SOLVENT)))


def app_system():
    """Phase 9's System: APP_FRAMES Cartesian frames of the 32-atom
    molecule in its 4-atom shell."""
    from tfep_tpu_torch.io.traj import System

    return System(app_topology(), cartesian_frames(APP_FRAMES).reshape(
        -1, CART_ATOMS, 3))


def app_map(device, system, potential, logs, state=None, batch=None):
    """Phase 9's CartesianMAFMap on ``system`` with ``potential``, set up,
    with phase 8's weights ``state`` where given; ``logs`` is the
    logger's directory (None: no logger); ``batch`` rows per step (B by
    default)."""
    from tfep_tpu_torch.app import CartesianMAFMap
    from tfep_tpu_torch.nn.transformers import NeuralSplineTransformer
    from tfep_tpu_torch.units import ureg

    n_mol = CART_ATOMS - CART_SOLVENT
    spline = NeuralSplineTransformer(-3.0 * np.ones(CART_F),
                                     3.0 * np.ones(CART_F), K,
                                     device=device)
    tfep_map = CartesianMAFMap(
        potential_energy_func=potential,
        temperature=300.0 * ureg.kelvin, system=system,
        batch_size=B if batch is None else batch,
        tfep_logger_dir_path=logs,
        mapped_atoms=list(range(1, n_mol)), conditioning_atoms=[0],
        origin_atom=0, axes_atoms=[1, 2], pca_whitening=True,
        n_maf_layers=N_LAYERS, flow_kwargs=dict(transformer=spline),
        device=device, dtype=torch.float32)
    tfep_map.setup()
    if state is not None:
        tfep_map.flow.load_state_dict(state, strict=True)
    return tfep_map


def app_phase(device, smi, handoff):
    """Phase 9: the port's CartesianMAFMap through Trainer.fit, checks
    (a)-(d), host and device times."""
    import os
    import shutil
    import tempfile

    from tfep_tpu_torch.app import Trainer
    from tfep_tpu_torch.ops.spline import LAUNCHES

    n_mol = CART_ATOMS - CART_SOLVENT
    system = app_system()
    work = tempfile.mkdtemp(prefix='tfep_app_')

    def new_map(name, state=None):
        return app_map(device, system, HarmonicPotential(),
                       os.path.join(work, name, 'logs'), state)

    def trainer(name, **kwargs):
        kwargs.setdefault('max_epochs', APP_EPOCHS)
        return Trainer(save_dir=os.path.join(work, name, 'ckpt'),
                       shuffle=True, shuffle_seed=0, prefetch=True, **kwargs)

    try:
        state = handoff['state']
        t0 = time.perf_counter()
        tfep_map = new_map('a', state)
        setup_s = time.perf_counter() - t0
        say(f'  CartesianMAFMap on {APP_FRAMES} frames of {CART_ATOMS} atoms '
            f'(System, float32), batch {B}: setup() {setup_s:.2f} s (PCA '
            f'fit on {min(APP_FRAMES, tfep_map.pca_n_frames)} frames); the '
            f'flow takes phase '
            f'8\'s weights with load_state_dict(strict=True); {smi}')

        # (a) The map's forward against phase 8's flow, same weights.
        with torch.no_grad():
            out = tfep_map.forward({'positions': handoff['frames']})
        for label, ours, theirs in (('y', out['positions'], handoff['y']),
                                    ('log_det_J', out['log_det_J'],
                                     handoff['log_det_J'])):
            err, rel = rel_err(ours.double(), theirs.double())
            say(f'  (a) map.forward - phase 8 flow, {label}: max|diff| = '
                f'{err:.3e}, {rel:.3e} of scale (tolerance {APP_MAP_TOL:g});'
                f' bit-identical: {bool(torch.equal(ours, theirs))}')
            if not rel <= APP_MAP_TOL:
                raise AssertionError(f'(a) the map\'s {label} differs')

        # (b) One Trainer step: the first loss of phase 8's step.
        one = Trainer(save_dir=None, max_steps=1, shuffle=False)
        one.fit(tfep_map)
        ours, theirs = one.loss_history[0], handoff['first_loss']
        first_loss = ours
        diff = abs(ours - theirs) / max(1.0, abs(theirs))
        say(f'  (b) first loss: Trainer.fit {ours:.9g}, phase 8 step '
            f'{theirs:.9g}; difference {diff:.3e} of scale (tolerance '
            f'{APP_LOSS_TOL:g})')
        if not diff <= APP_LOSS_TOL:
            raise AssertionError('(b) the first loss differs')
        del tfep_map, one, out

        # (c) Two epochs through Trainer.fit, counted and profiled.
        tfep_map = new_map('c', state)
        fit = trainer('c', checkpoint_every_n_steps=10,
                      profile_dir=os.path.join(work, 'c', 'profile'),
                      profile_steps=(3, 9))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.reset()
        fit.fit(tfep_map)
        torch.cuda.synchronize()
        launches = (LAUNCHES.forward, LAUNCHES.backward)
        peak = torch.cuda.max_memory_allocated()
        losses = np.asarray(fit.loss_history)
        say(f'  (c) Trainer(max_epochs={APP_EPOCHS}, shuffle_seed=0, '
            f'prefetch=True, checkpoint_every_n_steps=10): '
            f'{fit.global_step} steps, K1/K2 launches {launches} '
            f'({launches[0] / fit.global_step:g}/'
            f'{launches[1] / fit.global_step:g} per step); losses '
            f'{losses[0]:.6g} -> {losses[-1]:.6g}')
        if fit.global_step != APP_STEPS or len(losses) != APP_STEPS:
            raise AssertionError('(c) the trainer did not take 20 steps')
        if launches != (N_LAYERS * APP_STEPS, N_LAYERS * APP_STEPS):
            raise AssertionError(f'(c) K1/K2 launched {launches}')
        if not np.all(np.isfinite(losses)):
            raise AssertionError('(c) a loss is not finite')
        expected = app_orders(0, APP_EPOCHS)
        logger = tfep_map.tfep_logger
        for step, indices in enumerate(expected):
            rows = logger.read_train_tensors(step_idx=step)
            if not (np.array_equal(rows['dataset_sample_index'], indices)
                    and np.all(np.isfinite(rows['potential']))
                    and np.all(np.isfinite(rows['log_det_J']))):
                raise AssertionError(f'(c) step {step} lacks its log rows')
        say(f'  (c) every step\'s {B} rows in tfep_logger.read_train_tensors'
            f', in the sampler\'s order for shuffle_seed=0, finite')
        batch = tfep_map.batch_to_device(tfep_map.host_tensors(
            tfep_map.dataset.get_batch(np.arange(B))))
        with torch.no_grad():
            y = tfep_map.forward(batch)['positions']
        if not torch.equal(y[:, 3 * n_mol:], batch['positions'][:, 3 * n_mol:]):
            raise AssertionError('(c) a fixed atom moved')
        say(f'  (c) fixed atoms {n_mol}-{CART_ATOMS - 1} bit-identical '
            'through tfep_map.forward after training')

        # Times of (c): the profiled window, the host's work, a checkpoint.
        window = fit.profiled_step_times
        window_ms = 1e3 * sum(window) / len(window)
        kinds = kernel_kinds(fit.profile)
        busy_ms = sum(us for _, us in kinds.values()) / len(window) / 1e3
        ckpt_bytes = os.path.getsize(fit.checkpoint_path)
        checkpoint_ms = 1e3 * (fit.host_seconds['checkpoint'][0]
                               / fit.host_seconds['checkpoint'][1])
        trained = [p.detach().clone() for p in tfep_map.flow.parameters()]
        del tfep_map, fit, batch, y

        # Trainer.fit's step unprofiled, with the logger and without: the
        # difference of two runs of different length. The host's work per
        # call comes from the longer run with the logger.
        walls = {}
        for logger in (True, False):
            for steps in (APP_TIMED_STEPS, 2 * APP_TIMED_STEPS):
                tfep_map = new_map(f'timed{steps}', state)
                if not logger:
                    tfep_map._tfep_logger_dir_path = None
                timed = Trainer(save_dir=None, max_steps=steps,
                                shuffle=True, shuffle_seed=0, prefetch=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                timed.fit(tfep_map)
                torch.cuda.synchronize()
                walls[logger, steps] = time.perf_counter() - t0
                if logger:
                    host = {name: 1e3 * total / calls for name, (total, calls)
                            in timed.host_seconds.items()}
                del tfep_map, timed
        step_ms, nolog_ms = (
            1e3 * (walls[logger, 2 * APP_TIMED_STEPS]
                   - walls[logger, APP_TIMED_STEPS]) / APP_TIMED_STEPS
            for logger in (True, False))
        bare_ms, bare_busy = handoff['step_ms'], handoff['busy_ms']
        say(f'  Trainer.fit step: {step_ms:.3f} ms unprofiled ((fit of '
            f'{2 * APP_TIMED_STEPS} steps - fit of {APP_TIMED_STEPS} steps) /'
            f' {APP_TIMED_STEPS}), {B / step_ms * 1e3:.0f} frames/s; '
            f'without the logger {nolog_ms:.3f} ms, '
            f'{B / nolog_ms * 1e3:.0f} frames/s; phase 8\'s bare step in this '
            f'run {bare_ms:.3f} ms, {B / bare_ms * 1e3:.0f} frames/s; {smi}')
        say(f'  Trainer.fit profiled window (steps 3-8, torch.profiler on): '
            f'{window_ms:.3f} ms per step; device busy {busy_ms:.3f} ms per '
            f'step (phase 8\'s bare step {bare_busy:.3f} ms), idle share '
            f'{1.0 - busy_ms / step_ms:.3f} of the unprofiled step '
            f'({1.0 - busy_ms / nolog_ms:.3f} without the logger, '
            f'{1.0 - bare_busy / bare_ms:.3f} for phase 8), '
            f'{1.0 - busy_ms / window_ms:.3f} of the profiled window; '
            f'{smi}')
        for kind, (count, us) in sorted(kinds.items(),
                                        key=lambda kv: -kv[1][1]):
            say(f'    {kind}: {us / len(window) / 1e3:.3f} ms per step, '
                f'{count / len(window):.0f} kernels per step')
        say(f'  host ms per call, unprofiled run of {2 * APP_TIMED_STEPS} '
            'steps: ' + ', '.join(f'{name} {ms:.3f}'
                                  for name, ms in host.items())
            + f' (read on the prefetch thread); checkpoint save '
            f'{checkpoint_ms:.1f} ms for {ckpt_bytes / 1e6:.1f} MB; peak '
            f'memory {peak / 2**20:.1f} MiB; {smi}')

        # (d) Stopped at step 15, resumed from last.ckpt.
        crashed = trainer('d', max_steps=APP_CRASH_STEP,
                          checkpoint_every_n_steps=5)
        crashed.fit(new_map('d', state))
        resumed_map = new_map('d')
        resumed = trainer('d', checkpoint_every_n_steps=5)
        resumed.fit(resumed_map, resume=True)
        rows = resumed_map.tfep_logger.read_train_tensors(epoch_idx=1)
        seen = np.sort(rows['dataset_sample_index'])
        if not (resumed.global_step == APP_STEPS
                and len(resumed.loss_history) == APP_STEPS - APP_CRASH_STEP
                and np.array_equal(seen, np.arange(APP_FRAMES))):
            raise AssertionError('(d) the resumed run does not cover epoch 1 '
                                 'once')
        worst, identical = 0.0, True
        for a, b in zip(resumed_map.flow.parameters(), trained):
            worst = max(worst, float((a.detach() - b).abs().max()))
            identical &= bool(torch.equal(a.detach(), b))
        say(f'  (d) stopped at step {APP_CRASH_STEP}, resumed from last.ckpt:'
            f' {len(resumed.loss_history)} more steps, epoch 1\'s '
            f'{APP_FRAMES} samples each logged once; final weights against '
            f'the uninterrupted run of (c): max|diff| {worst:.3e} '
            f'(tolerance {APP_RESUME_TOL:g}), bit-identical: {identical}')
        if not worst <= APP_RESUME_TOL:
            raise AssertionError('(d) the resumed weights differ')
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(setup_s=setup_s, step_ms=step_ms, first_loss=first_loss,
                frames_per_s=B / step_ms * 1e3, step_ms_without_logger=nolog_ms,
                window_ms=window_ms,
                busy_ms=busy_ms, idle_share=1.0 - busy_ms / step_ms,
                bare_step_ms=bare_ms, bare_busy_ms=bare_busy,
                host_ms=host, checkpoint_ms=checkpoint_ms,
                checkpoint_bytes=ckpt_bytes, peak_bytes=peak,
                launches=launches, resume_max_diff=worst)


# ---------------------------------------------------------------------------
# Phase 10: the flagship map. The port's MixedMAFMap at the configuration
# of bench.py's bench_mixed_jax (bench.py:219-262), trained through
# Trainer.fit.
# ---------------------------------------------------------------------------

HELIX_ATOMS = 32
MIXED_FRAMES = APP_FRAMES
MIXED_BINS = 8
# The Z-matrix the JAX package's MixedMAFMap builds for the helix (the
# port's equals it: tests/test_torch_app_mixedmaf.py holds both to this
# literal). One fragment grown from its centre, atom 15, with the axes
# atoms 14 and 16.
HELIX_Z_MATRIX = np.array([
    [13, 14, 15, 16], [17, 16, 15, 14], [12, 13, 14, 15], [18, 17, 16, 15],
    [11, 12, 13, 14], [19, 18, 17, 16], [10, 11, 12, 13], [20, 19, 18, 17],
    [9, 10, 11, 12], [21, 20, 19, 18], [8, 9, 10, 11], [22, 21, 20, 19],
    [7, 8, 9, 10], [23, 22, 21, 20], [6, 7, 8, 9], [24, 23, 22, 21],
    [5, 6, 7, 8], [25, 24, 23, 22], [4, 5, 6, 7], [26, 25, 24, 23],
    [3, 4, 5, 6], [27, 26, 25, 24], [2, 3, 4, 5], [28, 27, 26, 25],
    [1, 2, 3, 4], [29, 28, 27, 26], [0, 1, 2, 3], [30, 29, 28, 27],
    [31, 30, 29, 28]])
# The mixed transformer's groups: distances (the 29 bonds, d01, d02),
# angles (29 and a102) and torsions (29); the six kept-constant reference
# DOFs are conditioning. Only the angle spline is in the standard
# configuration, so K1/K2 run at F = 30.
HELIX_GROUPS = (31, 30, 29)
HELIX_DOFS = 96
HELIX_LEVELS = 15
MIXED_F = HELIX_GROUPS[1]
# Trainer.fit's steps between the two unprofiled runs whose difference
# times a step.
MIXED_TIMED_STEPS = 10
# The float32 map against the float64 unfused path is held at MAP_TOL on
# the frames whose float32 conversion is well conditioned: the frame
# rotation (arccos/arcsin of clipped cosines, reference_frame_rotation_
# matrix) and the Z-matrix angles (arccos in cartesian_to_internal) within
# CONDITION_TOL of float64's. A frame off by more carries that error into
# the MAF's conditioning inputs, as in phase 8; it is held in float64
# (finite, and its round trip) instead.
CONDITION_TOL = 1e-6


def helix_frames(n, rng):
    """(n, 32, 3) frames of bench.py's helix chain: consecutive bond angles
    about 63 degrees from collinear, 0.05 A of Gaussian noise."""
    turns = np.arange(HELIX_ATOMS) * 1.2
    base = np.stack([1.5 * np.cos(turns), 1.5 * np.sin(turns),
                     0.3 * np.arange(HELIX_ATOMS)], axis=1)
    return base[None] + 0.05 * rng.normal(size=(n, HELIX_ATOMS, 3))


def conversion_error(conversion, frames):
    """Per frame, how far the float32 conversion's ill-conditioned steps
    are from float64: max|R32 - R64| of the frame rotation and the largest
    |theta32 - theta64| of the Z-matrix angles."""
    from tfep_tpu_torch.ops.zmatrix import cartesian_to_internal
    from tfep_tpu_torch.utils.geometry import reference_frame_rotation_matrix
    atoms = frames.double().reshape(frames.shape[0], -1, 3)
    ref = atoms[:, conversion.cartesian_atom_indices[-3:]]
    rel = ref[:, 1:] - ref[:, :1]
    rotations, angles = [], []
    for dtype in (torch.float32, torch.float64):
        eye = torch.eye(3, dtype=dtype, device=frames.device)
        rotations.append(reference_frame_rotation_matrix(
            rel[:, 0].to(dtype), rel[:, 1].to(dtype), axis=eye[0],
            plane_axis=eye[1], project_on_positive_axis=True).double())
        angles.append(cartesian_to_internal(
            atoms.to(dtype), conversion.z_matrix,
            normalize_angles=False)[1].double())
    return ((rotations[0] - rotations[1]).abs().amax(dim=(1, 2)),
            (angles[0] - angles[1]).abs().amax(dim=1))


def conversion_profile(conversion, frames, smi, n=5):
    """The conversion's part of a training step, from torch.profiler:
    cartesian_to_mixed forward (its outputs need no gradient: the data do
    not depend on the weights) and mixed_to_cartesian forward and
    backward, with the MAF's output standing in as a leaf."""
    from torch.profiler import ProfilerActivity, profile

    def step():
        y, ldj, origin, rotation = conversion.cartesian_to_mixed(frames)
        y = y.detach().requires_grad_()
        x, ldj_back = conversion.mixed_to_cartesian(y, origin, rotation)
        torch.autograd.backward((x, ldj_back),
                                (torch.ones_like(x), torch.ones_like(ldj)))

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kinds = kernel_kinds(prof)
    busy_ms = sum(us for _, us in kinds.values()) / n / 1e3
    count = sum(c for c, _ in kinds.values()) / n
    say(f'  conversion (cartesian_to_mixed + mixed_to_cartesian, forward '
        f'and backward, {conversion.placement_schedule.n_levels} placement '
        f'levels) at batch {frames.shape[0]}: device {busy_ms:.3f} ms in '
        f'{count:.0f} kernels per step (torch.profiler); wall clock alone '
        f'{wall_ms:.3f} ms; {smi}')
    return dict(busy_ms=busy_ms, kernels=count, wall_ms=wall_ms)


def mixed_phase(device, smi):
    """Phase 10: the port's MixedMAFMap at bench_mixed_jax's
    configuration, checks (a)-(f), times."""
    import os
    import shutil
    import tempfile

    from tfep_tpu_torch.app import MixedMAFMap, Trainer
    from tfep_tpu_torch.io.topology import Topology
    from tfep_tpu_torch.io.traj import System
    from tfep_tpu_torch.ops import spline as fs
    from tfep_tpu_torch.units import ureg

    # (a) K1/K2 against their plain version at the angle spline's width.
    errors = kernel_phase(device, MIXED_F)

    topology = Topology(names=[f'C{i}' for i in range(HELIX_ATOMS)],
                        elements=['C'] * HELIX_ATOMS,
                        bonds=[(i, i + 1) for i in range(HELIX_ATOMS - 1)])
    system = System(topology, helix_frames(
        MIXED_FRAMES, np.random.default_rng(SEED)).astype(np.float32))
    work = tempfile.mkdtemp(prefix='tfep_mixed_')

    def new_map(name, state=None, logger=True):
        tfep_map = MixedMAFMap(
            potential_energy_func=HarmonicPotential(),
            temperature=300.0 * ureg.kelvin, system=system, batch_size=B,
            tfep_logger_dir_path=(os.path.join(work, name, 'logs')
                                  if logger else None),
            n_maf_layers=N_LAYERS, n_bins=MIXED_BINS, device=device,
            dtype=torch.float32)
        tfep_map.setup()
        if state is not None:
            tfep_map.flow.load_state_dict(state, strict=True)
        return tfep_map

    try:
        t0 = time.perf_counter()
        tfep_map = new_map('a')
        setup_s = time.perf_counter() - t0
        flow = tfep_map.flow
        mixed = flow.flow[0].transformer
        n_params = sum(p.numel() for p in flow.parameters())
        say(f'  MixedMAFMap on {MIXED_FRAMES} frames of the {HELIX_ATOMS}-'
            f'atom helix (System, float32), batch {B}, {N_LAYERS} MAF layers, '
            f'{MIXED_BINS} bins: setup() {setup_s:.2f} s (Z-matrix, dataset '
            f'pass for the spline domains); {n_params} parameters; MADE '
            f'{flow.flow[0].conditioner.dimension_in} -> '
            f'{flow.flow[0].conditioner.dimensions_hidden} -> '
            f'{flow.flow[0].conditioner.dimension_out}; {smi}')

        # (b) The Z-matrix and the transformer's groups.
        groups = tuple(len(g) for g in mixed.indices)
        levels = flow.placement_schedule.n_levels
        same_z = np.array_equal(flow.z_matrix.cpu().numpy(), HELIX_Z_MATRIX)
        say(f'  (b) Z-matrix of {flow.n_ic_atoms} rows equal to the JAX '
            f'map\'s: {same_z}; mixed DOFs {flow.n_dofs_out}; transformer '
            f'groups {groups} (distances, angles, torsions); {levels} '
            'placement levels')
        if not (same_z and groups == HELIX_GROUPS
                and flow.n_dofs_out == HELIX_DOFS
                and levels == HELIX_LEVELS):
            raise AssertionError('(b) the map is not the JAX map\'s')

        # Random weights: identity initialization zeroes the output gains.
        generator = torch.Generator().manual_seed(SEED)
        with torch.no_grad():
            for p in flow.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=generator).to(p))
        state = {k: v.detach().clone() for k, v in flow.state_dict().items()}

        # (c) The float32 kernel path against the float64 unfused path.
        batch = tfep_map.batch_to_device(tfep_map.host_tensors(
            tfep_map.dataset.get_batch(np.arange(B))))
        frames = batch['positions']
        rotation_err, angle_err = conversion_error(flow, frames)
        conditioned = (rotation_err <= CONDITION_TOL) & (
            angle_err <= CONDITION_TOL)
        say(f'  {int((~conditioned).sum())} of {B} frames take a float32 '
            f'frame rotation or Z-matrix angle more than {CONDITION_TOL:g} '
            f'off float64\'s (rotation at most '
            f'{float(rotation_err.max()):.3e}, angles at most '
            f'{float(angle_err.max()):.3e})')
        reference = copy.deepcopy(flow).double()
        set_fused(reference, 'never')
        with torch.no_grad():
            y_k, ldj_k = flow(frames)
            y_p, ldj_p = reference(frames.double())
        for label, kern, plain in (('y', y_k, y_p),
                                   ('log_det_J', ldj_k, ldj_p)):
            if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()
                    and within(label, '(c) map (conditioned frames)',
                               'kernel path - float64 unfused path',
                               kern[conditioned], plain[conditioned])):
                raise AssertionError(f'(c) map {label} disagrees')
        if not conditioned.all():
            round_trip(reference, frames[~conditioned].double(),
                       '(f) round trip of the other frames, float64')
        del reference

        # (f) A round trip of the float32 kernel path.
        round_trip(flow, frames[conditioned], '(f) round trip')

        # (d), (e) One epoch through Trainer.fit, counted and profiled.
        del tfep_map, flow, batch
        tfep_map = new_map('c', state)
        fit = Trainer(save_dir=os.path.join(work, 'c', 'ckpt'), max_epochs=1,
                      shuffle=True, shuffle_seed=0, prefetch=True,
                      checkpoint_every_n_steps=MIXED_FRAMES // B,
                      profile_dir=os.path.join(work, 'c', 'profile'),
                      profile_steps=(3, 8))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fs.LAUNCHES.reset()
        fit.fit(tfep_map)
        torch.cuda.synchronize()
        launches = (fs.LAUNCHES.forward, fs.LAUNCHES.backward)
        peak = torch.cuda.max_memory_allocated()
        losses = np.asarray(fit.loss_history)
        n_steps = MIXED_FRAMES // B
        say(f'  (d) Trainer(max_epochs=1, shuffle_seed=0, prefetch=True, a '
            f'checkpoint at the epoch\'s end): {fit.global_step} steps, '
            f'K1/K2 launches {launches} ({launches[0] / fit.global_step:g}/'
            f'{launches[1] / fit.global_step:g} per step); losses '
            f'{losses[0]:.6g} -> {losses[-1]:.6g}')
        if fit.global_step != n_steps or len(losses) != n_steps:
            raise AssertionError(f'(d) the trainer did not take {n_steps} '
                                 'steps')
        if launches != (N_LAYERS * n_steps, N_LAYERS * n_steps):
            raise AssertionError(f'(d) K1/K2 launched {launches}')
        if not np.all(np.isfinite(losses)):
            raise AssertionError('(e) a loss is not finite')
        logger = tfep_map.tfep_logger
        for step, indices in enumerate(app_orders(0, 1)):
            rows = logger.read_train_tensors(step_idx=step)
            if not (np.array_equal(rows['dataset_sample_index'], indices)
                    and np.all(np.isfinite(rows['potential']))
                    and np.all(np.isfinite(rows['log_det_J']))):
                raise AssertionError(f'(e) step {step} lacks its log rows')
        ckpt_bytes = os.path.getsize(fit.checkpoint_path)
        say(f'  (e) every step\'s {B} rows in tfep_logger.read_train_tensors, '
            f'in the sampler\'s order for shuffle_seed=0, finite; checkpoint '
            f'{ckpt_bytes / 1e6:.1f} MB in '
            f'{1e3 * fit.host_seconds["checkpoint"][0]:.1f} ms')
        window = fit.profiled_step_times
        window_ms = 1e3 * sum(window) / len(window)
        kinds = kernel_kinds(fit.profile)
        busy_ms = sum(us for _, us in kinds.values()) / len(window) / 1e3
        conversion = conversion_profile(tfep_map.flow, frames, smi)
        del tfep_map, fit

        # The step unprofiled, with the logger and without: the difference
        # of two fits of different length.
        walls, host = {}, {}
        for logger in (True, False):
            for steps in (MIXED_TIMED_STEPS, 2 * MIXED_TIMED_STEPS):
                tfep_map = new_map(f'timed{steps}', state, logger)
                timed = Trainer(save_dir=None, max_steps=steps, shuffle=True,
                                shuffle_seed=0, prefetch=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                timed.fit(tfep_map)
                torch.cuda.synchronize()
                walls[logger, steps] = time.perf_counter() - t0
                if logger:
                    host = {name: 1e3 * total / calls for name, (total, calls)
                            in timed.host_seconds.items()}
                del tfep_map, timed
        step_ms, nolog_ms = (
            1e3 * (walls[logger, 2 * MIXED_TIMED_STEPS]
                   - walls[logger, MIXED_TIMED_STEPS]) / MIXED_TIMED_STEPS
            for logger in (True, False))
        say(f'  Trainer.fit step: {step_ms:.3f} ms unprofiled, '
            f'{B / step_ms * 1e3:.0f} frames/s; without the logger '
            f'{nolog_ms:.3f} ms, {B / nolog_ms * 1e3:.0f} frames/s; {smi}')
        say(f'  profiled window (steps 3-7): {window_ms:.3f} ms per step; '
            f'device busy {busy_ms:.3f} ms per step, idle share '
            f'{1.0 - busy_ms / step_ms:.3f} of the unprofiled step '
            f'({1.0 - busy_ms / nolog_ms:.3f} without the logger); peak '
            f'memory {peak / 2**20:.1f} MiB; {smi}')
        for kind, (count, us) in sorted(kinds.items(),
                                        key=lambda kv: -kv[1][1]):
            say(f'    {kind}: {us / len(window) / 1e3:.3f} ms per step, '
                f'{count / len(window):.0f} kernels per step')
        say('  host ms per call, unprofiled run of '
            f'{2 * MIXED_TIMED_STEPS} steps: '
            + ', '.join(f'{name} {ms:.3f}' for name, ms in host.items()))

        # K1/K2 at the angle spline's width.
        sets = spline_sets(device, MIXED_F)
        consts = (K, 1e-4, 1e-4)
        kernel_ms = {}
        for name, launch, nbytes, nops in (
                ('spline_forward',
                 lambda x, p, b, gy, gl: fs.launch_forward(x, p, *b, *consts),
                 fs.forward_bytes(B, MIXED_F, K, 4),
                 fs.forward_ops(B, MIXED_F, K)),
                ('spline_backward',
                 lambda x, p, b, gy, gl: fs.launch_backward(
                     x, p, *b, gy, gl, *consts),
                 fs.backward_bytes(B, MIXED_F, K, 4),
                 fs.backward_ops(B, MIXED_F, K))):
            runs = [graph_ms(launch, sets, 64, 5) for _ in range(2)]
            kernel_ms[name] = sum(runs) / 2
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           nops / FP32_OPS_PER_S) * 1e3
            say(f'  {name} at F={MIXED_F}: {kernel_ms[name]:.5f} ms (CUDA '
                f'graph, runs {runs[0]:.5f}, {runs[1]:.5f}); bound '
                f'{bound_ms:.5f} ms ({nbytes / 1e6:.1f} MB), '
                f'{bound_ms / kernel_ms[name]:.3f} of it; [{smi}]')
        del sets
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(errors=errors, launches=launches, setup_s=setup_s,
                step_ms=step_ms, frames_per_s=B / step_ms * 1e3,
                step_ms_without_logger=nolog_ms, window_ms=window_ms,
                busy_ms=busy_ms, idle_share=1.0 - busy_ms / step_ms,
                conversion=conversion, host_ms=host, kernel_ms=kernel_ms,
                peak_bytes=peak, checkpoint_bytes=ckpt_bytes,
                ill_conditioned_frames=int((~conditioned).sum()))


# ---------------------------------------------------------------------------
# Phase 11: the CNF map. The port's ContinuousEGNNMap at
# benchmarks/cnf_bench.py's configuration, trained through Trainer.fit.
# ---------------------------------------------------------------------------

CNF_MAP_FRAMES = 4 * CNF_BATCH
CNF_MAP_STEPS = 4
CNF_CRASH_STEP = 2


def cnf_map_phase(device, smi, handoff):
    """Phase 11: checks (a)-(d) and times. ``handoff`` holds phase 6's
    weights and frames, on the host, and phase 7's step and busy time
    where they were measured."""
    import os
    import shutil
    import tempfile

    from tfep_tpu_torch.app import ContinuousEGNNMap, Trainer
    from tfep_tpu_torch.io.topology import Topology
    from tfep_tpu_torch.io.traj import System
    from tfep_tpu_torch.ops.egnn import LAUNCHES
    from tfep_tpu_torch.units import ureg

    state, first = handoff['state'], handoff['frames']
    # Phase 6's frames first, then more of the same 0.5 N(0, 1).
    rest = 0.5 * torch.randn(CNF_MAP_FRAMES - CNF_BATCH, first.shape[1],
                             generator=torch.Generator().manual_seed(SEED + 1))
    system = System(Topology(names=[f'C{i}' for i in range(N_ATOMS)],
                             elements=['C'] * N_ATOMS),
                    torch.cat([first, rest]).numpy().reshape(-1, N_ATOMS, 3))
    work = tempfile.mkdtemp(prefix='tfep_cnfmap_')

    def new_map(name):
        tfep_map = ContinuousEGNNMap(
            potential_energy_func=HarmonicPotential(),
            temperature=300.0 * ureg.kelvin, system=system,
            batch_size=CNF_BATCH,
            tfep_logger_dir_path=os.path.join(work, name, 'logs'),
            node_types=np.arange(N_ATOMS) % 4, r_cutoff=R_CUTOFF,
            n_egnn_layers=CNF_LAYERS, node_feat_dim=CNF_FEAT,
            distance_feat_dim=CNF_FEAT, time_feat_dim=16, solver='rk4',
            n_steps=ODE_STEPS, trace_estimator='hutchinson',
            n_hutchinson_samples=1, regularization=True,
            egnn_kwargs={'pairwise': 'pallas', 'initialize_identity': False},
            device=device, dtype=torch.float32)
        tfep_map.setup()
        tfep_map.flow.load_state_dict(state, strict=True)
        return tfep_map

    def trainer(name, **kwargs):
        return Trainer(save_dir=os.path.join(work, name, 'ckpt'),
                       shuffle=True, shuffle_seed=0, prefetch=True, **kwargs)

    try:
        tfep_map = new_map('a')
        paths = [layer.pairwise for layer in
                 tfep_map.flow.dynamics.graph_layers]
        say(f'  ContinuousEGNNMap on {CNF_MAP_FRAMES} frames of {N_ATOMS} '
            f'atoms, batch {CNF_BATCH}, egnn_kwargs pairwise=\'pallas\' built '
            f'pairwise={paths}; phase 6\'s weights with '
            f'load_state_dict(strict=True); {smi}')
        if paths != ['fused'] * CNF_LAYERS:
            raise AssertionError('pairwise=\'pallas\' did not build the '
                                 'fused path')

        # (a) The map's forward against phase 6's flow, same probe.
        batch = tfep_map.batch_to_device(tfep_map.host_tensors(
            tfep_map.dataset.get_batch(np.arange(CNF_BATCH))))
        eps = tfep_map.flow.probes(batch['positions'],
                                   tfep_map.probe_generator(batch))
        reference, _ = build_cnf(device)
        reference.load_state_dict(state, strict=True)
        with torch.no_grad():
            out = tfep_map.forward(batch)
            ref = reference.integrate(first.to(device), eps)
        del reference
        for label, ours, theirs in zip(('y', 'log_det_J', 'reg'),
                                       (out['positions'], out['log_det_J'],
                                        out['regularization']), ref):
            err, rel = rel_err(ours.double(), theirs.double())
            say(f'  (a) map.forward - phase 6 flow, {label}: max|diff| = '
                f'{err:.3e}, {rel:.3e} of scale (tolerance {APP_MAP_TOL:g});'
                f' bit-identical: {bool(torch.equal(ours, theirs))}')
            if not rel <= APP_MAP_TOL:
                raise AssertionError(f'(a) the map\'s {label} differs')

        # (c) Two steps on the same batch draw different probes; one step
        # draws the same twice.
        probes = [tfep_map.flow.probes(batch['positions'],
                                       tfep_map.probe_generator(
                                           {**batch, 'global_step': s}))
                  for s in (0, 1, 0)]
        say(f'  (c) probes of steps 0 and 1 on one batch differ: '
            f'{not torch.equal(probes[0], probes[1])}; step 0 twice equal: '
            f'{torch.equal(probes[0], probes[2])}')
        if torch.equal(probes[0], probes[1]) or not torch.equal(probes[0],
                                                                probes[2]):
            raise AssertionError('(c) the probes do not refresh per step')
        del tfep_map, out, ref, probes

        # (b) Trainer.fit, counted and timed (one checkpoint, at its end).
        def timed_fit(fit, tfep_map, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit.fit(tfep_map, **kwargs)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        tfep_map = new_map('b')
        fit = trainer('b', max_steps=CNF_MAP_STEPS,
                      checkpoint_every_n_steps=CNF_MAP_STEPS)
        torch.cuda.reset_peak_memory_stats()
        LAUNCHES.reset()
        wall = {CNF_MAP_STEPS: timed_fit(fit, tfep_map)}
        launches = (LAUNCHES.k3, LAUNCHES.k4, LAUNCHES.k5)
        peak = torch.cuda.max_memory_allocated()
        losses = np.asarray(fit.loss_history)
        expected = (0, 2 * BLOCKS_PER_PASS * CNF_MAP_STEPS,
                    BLOCKS_PER_PASS * CNF_MAP_STEPS)
        say(f'  (b) Trainer(max_steps={CNF_MAP_STEPS}, prefetch=True): '
            f'K3/K4/K5 launches {launches}, per step '
            f'{launches[1] // CNF_MAP_STEPS}/{launches[2] // CNF_MAP_STEPS} '
            f'K4/K5 ({BLOCKS_PER_PASS} K4 forward, {BLOCKS_PER_PASS} '
            f'recomputed under checkpoint); losses {losses.tolist()}')
        if launches != expected or len(losses) != CNF_MAP_STEPS:
            raise AssertionError(f'(b) K3/K4/K5 launched {launches}')
        if not np.all(np.isfinite(losses)):
            raise AssertionError('(b) a loss is not finite')
        trained = [p.detach().clone() for p in tfep_map.flow.parameters()]
        del tfep_map, fit

        # (d) Stopped after step 2 (timed: one checkpoint, at its end),
        # resumed from last.ckpt with steps 2-3 profiled.
        crashed = trainer('d', max_steps=CNF_CRASH_STEP,
                          checkpoint_every_n_steps=CNF_CRASH_STEP)
        wall[CNF_CRASH_STEP] = timed_fit(crashed, new_map('d'))
        host = {name: 1e3 * total / calls
                for name, (total, calls) in crashed.host_seconds.items()}
        resumed_map = new_map('d')
        resumed = trainer('d', max_steps=CNF_MAP_STEPS,
                          checkpoint_every_n_steps=CNF_CRASH_STEP,
                          profile_dir=os.path.join(work, 'd', 'profile'),
                          profile_steps=(CNF_CRASH_STEP, CNF_MAP_STEPS))
        resumed.fit(resumed_map, resume=True)
        worst, identical = 0.0, True
        for a, b in zip(resumed_map.flow.parameters(), trained):
            if a.numel():
                worst = max(worst, float((a.detach() - b).abs().max()))
            identical &= bool(torch.equal(a.detach(), b))
        say(f'  (d) stopped after step {CNF_CRASH_STEP}, resumed from '
            f'last.ckpt: {len(resumed.loss_history)} more steps; final '
            f'weights against the uninterrupted run of (b): max|diff| '
            f'{worst:.3e} (tolerance {APP_RESUME_TOL:g}), bit-identical: '
            f'{identical}')
        if not (resumed.global_step == CNF_MAP_STEPS and worst
                <= APP_RESUME_TOL):
            raise AssertionError('(d) the resumed weights differ')

        window = resumed.profiled_step_times
        window_ms = 1e3 * sum(window) / len(window)
        kinds = kernel_kinds(resumed.profile)
        busy_ms = sum(us for _, us in kinds.values()) / len(window) / 1e3
        step_ms = 1e3 * (wall[CNF_MAP_STEPS] - wall[CNF_CRASH_STEP]) / (
            CNF_MAP_STEPS - CNF_CRASH_STEP)
        say(f'  Trainer.fit step: {step_ms:.2f} ms unprofiled ((fit of '
            f'{CNF_MAP_STEPS} steps - fit of {CNF_CRASH_STEP} steps) / '
            f'{CNF_MAP_STEPS - CNF_CRASH_STEP}; the fits took '
            f'{wall[CNF_MAP_STEPS]:.2f} and {wall[CNF_CRASH_STEP]:.2f} s), '
            f'{CNF_BATCH / step_ms * 1e3:.1f} frames/s; profiled window '
            f'(steps {CNF_CRASH_STEP}-{CNF_MAP_STEPS - 1} of the resumed '
            f'run) {window_ms:.2f} ms per step; device busy {busy_ms:.2f} '
            f'ms per step, idle share {1.0 - busy_ms / step_ms:.3f}; peak '
            f'memory {peak / 2**20:.1f} MiB; host ms per call (the fit of '
            f'{CNF_CRASH_STEP}): '
            + ', '.join(f'{name} {ms:.3f}' for name, ms in host.items())
            + f'; {smi}')
        if 'step_ms' in handoff:
            say(f'  phase 7\'s bare step in this run: {handoff["step_ms"]:.2f} '
                f'ms, device busy {handoff["busy_ms"]:.2f} ms')
        for kind, (count, us) in sorted(kinds.items(),
                                        key=lambda kv: -kv[1][1]):
            say(f'    {kind}: {us / len(window) / 1e3:.3f} ms per step, '
                f'{count / len(window):.0f} kernels per step')
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(launches=dict(zip(('k3', 'k4', 'k5'), launches)),
                step_ms=step_ms, frames_per_s=CNF_BATCH / step_ms * 1e3,
                window_ms=window_ms, busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / step_ms, host_ms=host,
                peak_bytes=peak, resume_max_diff=worst)


# ---------------------------------------------------------------------------
# Phase 12: from a trajectory file to Δf. Phase 10's flagship configuration
# written to an XTC and a PDB with the port's writers, trained lazily from
# the file through Trainer.fit, and the logged work turned into a Δf with a
# bootstrap interval on the card.
# ---------------------------------------------------------------------------

# Frames decoded by both the native and the pure-Python reader.
NATIVE_CHECK_FRAMES = 256
# The file map's run is stopped after this step and resumed from its
# checkpoint by a map rebuilt from the checkpoint (the paths only).
FILE_CRASH_STEP = 5
FILE_TIMED_STEPS = MIXED_TIMED_STEPS
ANALYSIS_RESAMPLES = 2000
# The card's estimate and bootstrap against numpy's float64 on the same
# work and the same resample indices, held at this fraction of
# max(1, |df|). The logged columns keep the map's float32, and so does the
# estimate on the card: a log-sum-exp of 40,960 float32 terms is a few
# 1e-7 relative off float64's, and its value (about 100 kT here) rounds to
# float32's 8e-6.
ANALYSIS_TOL = 1e-6
# The identity-map toy of tests/app/test_biased.py:40-48 (kT = 1, two
# atoms): A = N(0, 1) per DOF, B = N(0, sigma_B^2), biased frames drawn
# from N(0, sigma_S^2) under V(x) = -|x|^2 / 4.
TOY_FRAMES = MIXED_FRAMES
TOY_D = 6
TOY_SIGMA_B2 = 0.5
TOY_SIGMA_S = np.sqrt(2.0)
TOY_DF = -0.5 * TOY_D * np.log(TOY_SIGMA_B2)
TOY_WRONG_DF = 0.5 * TOY_D * np.log(1.0 + (1.0 / TOY_SIGMA_B2 - 1.0)
                                    * TOY_SIGMA_S ** 2)
# tests/app/test_biased.py's allowances: an interval may miss the analytic
# Δf by 0.1 kT; the unweighted estimate lands within 0.25 kT of its wrong
# limit and more than 0.8 kT from the analytic value.
TOY_SLACK = 0.1
TOY_WRONG_TOL = 0.25
TOY_MISS = 0.8


def write_dcd(path, positions):
    """A CHARMM-layout DCD of float32 angstrom frames, without a cell (the
    port reads DCD and writes none; this is the layout of
    tests/io/test_dcd.py's writer)."""
    import struct
    n_frames, n_atoms, _ = positions.shape
    with open(path, 'wb') as f:
        icntrl = [0] * 20
        icntrl[0] = n_frames
        f.write(struct.pack('<i4s20ii', 84, b'CORD', *icntrl, 84))
        f.write(struct.pack('<ii80si', 84, 1, b'tfep_tpu_torch'.ljust(80),
                            84))
        f.write(struct.pack('<iii', 4, n_atoms, 4))
        for frame in positions:
            for dim in range(3):
                f.write(struct.pack('<i', 4 * n_atoms))
                f.write(frame[:, dim].astype('<f4').tobytes())
                f.write(struct.pack('<i', 4 * n_atoms))


def lse64(x):
    """log-sum-exp over the last axis, numpy float64."""
    m = np.max(x, axis=-1, keepdims=True)
    return (m + np.log(np.sum(np.exp(x - m), axis=-1, keepdims=True)))[..., 0]


def file_phase(device, smi, mixed):
    """Phase 12: checks (a)-(e) and times. ``mixed`` is phase 10's result
    (its read time per step)."""
    import os
    import shutil
    import tempfile

    from tfep_tpu_torch.analysis import (
        bootstrap, estimate_from_logger, fep_estimator,
    )
    from tfep_tpu_torch.app import MixedMAFMap, Trainer
    from tfep_tpu_torch.io import dcd, frames as frame_stores
    from tfep_tpu_torch.io.native import (
        native_available, native_build_error, library_path,
    )
    from tfep_tpu_torch.io.topology import Topology
    from tfep_tpu_torch.io.traj import System, load_topology
    from tfep_tpu_torch.ops import spline as fs
    from tfep_tpu_torch.units import ureg

    work = tempfile.mkdtemp(prefix='tfep_files_')
    try:
        # (a) The files, written by the port's writers.
        topology = Topology(
            names=[f'C{i}' for i in range(HELIX_ATOMS)],
            elements=['C'] * HELIX_ATOMS,
            bonds=[(i, i + 1) for i in range(HELIX_ATOMS - 1)])
        positions = helix_frames(MIXED_FRAMES, np.random.default_rng(
            SEED)).astype(np.float32)
        pdb = os.path.join(work, 'helix.pdb')
        xtc = os.path.join(work, 'helix.xtc')
        t0 = time.perf_counter()
        System(topology, positions[:1]).save(pdb)
        pdb_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        System(topology, positions).save(xtc)
        xtc_s = time.perf_counter() - t0
        sizes = {'pdb': os.path.getsize(pdb), 'xtc': os.path.getsize(xtc)}
        with open(pdb) as f:
            conect = sum(line.startswith('CONECT') for line in f)
        say(f'  (a) helix.pdb (topology, {conect} CONECT records) '
            f'{sizes["pdb"]} bytes in {1e3 * pdb_s:.1f} ms; helix.xtc '
            f'({MIXED_FRAMES} frames, precision 1000) {sizes["xtc"]} bytes '
            f'({sizes["xtc"] / positions.nbytes:.3f} of float32) in '
            f'{xtc_s:.2f} s (the pure-Python XTC encoder)')
        if conect != HELIX_ATOMS:
            raise AssertionError('(a) the PDB lacks its CONECT bonds')

        # (b) The native library, built from this checkout by g++.
        t0 = time.perf_counter()
        available = native_available()
        build_s = time.perf_counter() - t0
        if not available:
            raise AssertionError('(b) the native trajectory library did not '
                                 f'build:\n{native_build_error()}')
        store = frame_stores.open_frame_store(xtc)
        idx = np.sort(np.random.default_rng(SEED).choice(
            MIXED_FRAMES, NATIVE_CHECK_FRAMES, replace=False))
        t0 = time.perf_counter()
        native = store[idx]
        native_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        python = store._py_load(store._offsets[idx])
        python_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        decoded = np.asarray(store)
        full_ms = 1e3 * (time.perf_counter() - t0)
        # Both decoders recover the stored integers (precision 1000, nm);
        # the native one multiplies them by a float32 1/precision, the
        # Python one divides in float64, so their floats may differ in the
        # last place (as in the JAX package).
        ints_native = np.rint(native.astype(np.float64) * 100.0)
        ints_python = np.rint(python.astype(np.float64) * 100.0)
        same_ints = np.array_equal(ints_native, ints_python)
        ulp = np.abs(native - python) / np.spacing(np.abs(python))
        quantized = np.abs(decoded - positions).max()
        say(f'  (b) {library_path().name} built by g++ in {build_s:.2f} s; '
            f'{NATIVE_CHECK_FRAMES} frames decoded natively in '
            f'{native_ms:.2f} ms and in Python in {python_ms:.1f} ms: the '
            f'stored integers bit-identical: {same_ints}; floats identical '
            f'on {float(np.mean(native == python)):.4f} of the coordinates, '
            f'at most {float(ulp.max()):.0f} ulp apart; the whole file '
            f'natively in {full_ms:.1f} ms, at most {quantized:.2e} A from '
            'the written frames')
        if not same_ints or quantized > 0.0051:
            raise AssertionError('(b) the XTC decoders disagree')
        dcd_path = os.path.join(work, 'helix.dcd')
        write_dcd(dcd_path, positions[idx])
        t0 = time.perf_counter()
        dcd_native, _ = dcd.read_dcd(dcd_path)
        dcd_native_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        dcd_python, _ = dcd._py_read_frames(dcd_path,
                                            np.arange(NATIVE_CHECK_FRAMES))
        dcd_python_ms = 1e3 * (time.perf_counter() - t0)
        dcd_same = (np.array_equal(dcd_native, dcd_python)
                    and np.array_equal(dcd_native, positions[idx]))
        say(f'  (b) the same {NATIVE_CHECK_FRAMES} frames as DCD '
            f'({os.path.getsize(dcd_path)} bytes): native '
            f'{dcd_native_ms:.2f} ms, Python {dcd_python_ms:.2f} ms, '
            f'bit-identical to each other and to the frames: {dcd_same}')
        if not dcd_same:
            raise AssertionError('(b) the DCD decoders disagree')
        files = dict(sizes=dict(sizes, dcd=os.path.getsize(dcd_path)),
                     xtc_write_s=xtc_s, native_build_s=build_s,
                     native_256_ms=native_ms, python_256_ms=python_ms,
                     native_full_ms=full_ms, dcd_native_256_ms=dcd_native_ms,
                     dcd_python_256_ms=dcd_python_ms,
                     max_ulp=float(ulp.max()))

        # (c) Training from the file, against the decoded frames in memory.
        def new_map(name, state=None, logger=True, from_file=True):
            source = (dict(coordinates_file_path=xtc, topology_file_path=pdb,
                           lazy_trajectory=True) if from_file else
                      dict(system=System(load_topology(pdb), decoded,
                                         dimensions=store.dimensions,
                                         times=store.times)))
            tfep_map = MixedMAFMap(
                potential_energy_func=HarmonicPotential(),
                temperature=300.0 * ureg.kelvin, batch_size=B,
                tfep_logger_dir_path=(os.path.join(work, name, 'logs')
                                      if logger else None),
                n_maf_layers=N_LAYERS, n_bins=MIXED_BINS, device=device,
                dtype=torch.float32, **source)
            t0 = time.perf_counter()
            tfep_map.setup()
            tfep_map.setup_s = time.perf_counter() - t0
            if state is not None:
                tfep_map.flow.load_state_dict(state, strict=True)
            return tfep_map

        def trainer(name, **kwargs):
            kwargs.setdefault('max_epochs', 1)
            return Trainer(save_dir=os.path.join(work, name, 'ckpt'),
                           shuffle=True, shuffle_seed=0, prefetch=True,
                           **kwargs)

        file_map = new_map('file')
        lazy = type(file_map._system.positions).__name__
        if lazy != 'XtcFrameStore' or file_map.hparams['system'] is not None:
            raise AssertionError('(c) the file map is not lazy')
        generator = torch.Generator().manual_seed(SEED)
        with torch.no_grad():
            for p in file_map.flow.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=generator).to(p))
        state = {k: v.detach().clone()
                 for k, v in file_map.flow.state_dict().items()}
        memory_map = new_map('memory', state, from_file=False)
        say(f'  (c) MixedMAFMap(coordinates_file_path=helix.xtc, '
            f'topology_file_path=helix.pdb, lazy_trajectory=True): setup() '
            f'{file_map.setup_s:.2f} s, the in-memory map of the decoded '
            f'frames {memory_map.setup_s:.2f} s; Z-matrix equal to phase '
            f'[10]\'s literal: '
            f'{np.array_equal(file_map.flow.z_matrix.cpu().numpy(), HELIX_Z_MATRIX)}')
        if not np.array_equal(file_map.flow.z_matrix.cpu().numpy(),
                              HELIX_Z_MATRIX):
            raise AssertionError('(c) the file map\'s Z-matrix differs')
        first = app_orders(0, 1)[0]
        batches = [m.dataset.get_batch(first) for m in (file_map, memory_map)]
        if not (sorted(batches[0]) == sorted(batches[1]) and all(
                np.array_equal(batches[0][k], batches[1][k])
                for k in batches[0])):
            raise AssertionError('(c) the first batches differ')
        fits = {}
        for name, tfep_map in (('file', file_map), ('memory', memory_map)):
            fit = trainer(name, checkpoint_every_n_steps=FILE_CRASH_STEP,
                          **({'profile_dir': os.path.join(work, 'profile'),
                              'profile_steps': (3, 8)}
                             if name == 'file' else {}))
            torch.cuda.synchronize()
            fs.LAUNCHES.reset()
            fit.fit(tfep_map)
            torch.cuda.synchronize()
            fits[name] = (fit, (fs.LAUNCHES.forward, fs.LAUNCHES.backward))
        (fit, launches), (mem_fit, _) = fits['file'], fits['memory']
        n_steps = MIXED_FRAMES // B
        rows = [m.tfep_logger.read_train_tensors(step_idx=0)
                for m in (file_map, memory_map)]
        first_same = (fit.loss_history[0] == mem_fit.loss_history[0]
                      and sorted(rows[0]) == sorted(rows[1])
                      and all(np.array_equal(rows[0][k], rows[1][k])
                              for k in rows[0]))
        all_losses_same = fit.loss_history == mem_fit.loss_history
        weights_same = all(torch.equal(a, b) for a, b in zip(
            file_map.flow.parameters(), memory_map.flow.parameters()))
        say(f'  (c) Trainer(max_epochs=1, shuffle_seed=0, prefetch=True, '
            f'checkpoints every {FILE_CRASH_STEP} steps) from the file: '
            f'{fit.global_step} steps, K1/K2 launches {launches} '
            f'({launches[0] / fit.global_step:g}/'
            f'{launches[1] / fit.global_step:g} per step); the first step\'s '
            f'batch, loss ({fit.loss_history[0]:.9g}) and {B} log rows '
            f'bit-identical to the in-memory map\'s: {first_same}; every '
            f'loss: {all_losses_same}; final weights: {weights_same}')
        if launches != (N_LAYERS * n_steps, N_LAYERS * n_steps):
            raise AssertionError(f'(c) K1/K2 launched {launches}')
        if not (first_same and np.all(np.isfinite(fit.loss_history))):
            raise AssertionError('(c) the file map\'s first step differs')
        window = fit.profiled_step_times
        window_ms = 1e3 * sum(window) / len(window)
        busy_ms = sum(us for _, us in kernel_kinds(
            fit.profile).values()) / len(window) / 1e3
        trained = [p.detach().clone() for p in file_map.flow.parameters()]
        logger = file_map.tfep_logger
        del memory_map, mem_fit, fits

        # The resume: a map rebuilt from the file map's checkpoint at step
        # FILE_CRASH_STEP rereads the file.
        crashed = trainer('crash', max_steps=FILE_CRASH_STEP,
                          checkpoint_every_n_steps=FILE_CRASH_STEP)
        crashed.fit(new_map('crash', state))
        resumed_map = MixedMAFMap.load_from_checkpoint(
            crashed.checkpoint_path,
            potential_energy_func=HarmonicPotential())
        reread = (type(resumed_map._system.positions).__name__ ==
                  'XtcFrameStore' and resumed_map.hparams['system'] is None)
        resumed = trainer('crash', checkpoint_every_n_steps=FILE_CRASH_STEP)
        resumed.fit(resumed_map, resume=True)
        resume_same = all(torch.equal(a.detach(), b) for a, b in zip(
            resumed_map.flow.parameters(), trained))
        say(f'  (c) stopped after step {FILE_CRASH_STEP}; '
            'MixedMAFMap.load_from_checkpoint rebuilt the map from the '
            f'paths and reread the file lazily: {reread}; resumed to step '
            f'{resumed.global_step}: final weights bit-identical to the '
            f'uninterrupted run\'s: {resume_same}')
        if not (reread and resume_same and resumed.global_step == n_steps):
            raise AssertionError('(c) the resume from the file differs')
        del resumed_map, resumed, crashed

        # The step from the file, with the logger and without.
        walls, host = {}, {}
        for with_logger in (True, False):
            for steps in (FILE_TIMED_STEPS, 2 * FILE_TIMED_STEPS):
                tfep_map = new_map(f'timed{steps}', state, with_logger)
                timed = Trainer(save_dir=None, max_steps=steps, shuffle=True,
                                shuffle_seed=0, prefetch=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                timed.fit(tfep_map)
                torch.cuda.synchronize()
                walls[with_logger, steps] = time.perf_counter() - t0
                if with_logger:
                    host = {name: 1e3 * total / calls for name, (total, calls)
                            in timed.host_seconds.items()}
                del tfep_map, timed
        step_ms, nolog_ms = (
            1e3 * (walls[lg, 2 * FILE_TIMED_STEPS]
                   - walls[lg, FILE_TIMED_STEPS]) / FILE_TIMED_STEPS
            for lg in (True, False))
        mixed_read = mixed['host_ms'].get('read', float('nan'))
        say(f'  Trainer.fit step from the file: {step_ms:.3f} ms unprofiled, '
            f'{B / step_ms * 1e3:.0f} frames/s; without the logger '
            f'{nolog_ms:.3f} ms; profiled window (steps 3-7) '
            f'{window_ms:.3f} ms, device busy {busy_ms:.3f} ms per step, idle '
            f'share {1.0 - busy_ms / step_ms:.3f} ({1.0 - busy_ms / nolog_ms:.3f} '
            f'without the logger); read (lazy XTC decode of {B} frames + '
            f'pinned copy, prefetch thread) {host["read"]:.3f} ms per step '
            f'against phase [10]\'s in-memory gather {mixed_read:.3f} ms; '
            f'{smi}')
        say('  host ms per call, unprofiled run of '
            f'{2 * FILE_TIMED_STEPS} steps: '
            + ', '.join(f'{name} {ms:.3f}' for name, ms in host.items()))

        # (d) Δf from the file map's logger, on the card.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        estimate = estimate_from_logger(logger, epoch_idx=0,
                                        n_resamples=ANALYSIS_RESAMPLES,
                                        device=device)
        torch.cuda.synchronize()
        call_ms = 1e3 * (time.perf_counter() - t0)
        w = estimate['work']
        n = len(w)
        if n != MIXED_FRAMES or estimate['n_samples'] != MIXED_FRAMES:
            raise AssertionError('(d) the estimate lacks work values')
        # The same bootstrap alone, between CUDA events.
        work_t = torch.as_tensor(w, device=device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        boot = bootstrap(work_t, fep_estimator,
                         n_resamples=ANALYSIS_RESAMPLES, seed=0)
        end.record()
        torch.cuda.synchronize()
        boot_ms = start.elapsed_time(end)
        # numpy float64 on the same work and the indices a generator on the
        # card seeded alike draws again.
        g = torch.Generator(device=device).manual_seed(0)
        idx = torch.randint(0, n, (ANALYSIS_RESAMPLES, n), generator=g,
                            device=device).cpu().numpy()
        stats = -lse64(-w[idx] - np.log(n))
        del idx
        low, high = np.quantile(stats, [0.025, 0.975])
        df64 = float(-lse64(-w - np.log(n)))
        diffs = [abs(estimate['df'] - df64),
                 abs(estimate['confidence_interval']['low'] - low),
                 abs(estimate['confidence_interval']['high'] - high),
                 abs(float(boot['confidence_interval']['low']) - low)]
        say(f'  (d) estimate_from_logger(epoch_idx=0, n_resamples='
            f'{ANALYSIS_RESAMPLES}) on the card: df {estimate["df"]:.9f} kT, '
            f'95% interval [{estimate["confidence_interval"]["low"]:.9f}, '
            f'{estimate["confidence_interval"]["high"]:.9f}]; numpy float64 '
            f'on the same work and indices: df {df64:.9f}, [{low:.9f}, '
            f'{high:.9f}]; largest difference {max(diffs):.3e} (tolerance '
            f'{ANALYSIS_TOL:g} of max(1, |df|); work in {w.dtype}); the call {call_ms:.1f} ms, the bootstrap '
            f'alone {boot_ms:.2f} ms (CUDA events, {ANALYSIS_RESAMPLES} x '
            f'{n}); {smi}')
        if not max(diffs) <= ANALYSIS_TOL * max(1.0, abs(df64)):
            raise AssertionError('(d) the card\'s Δf differs from float64')

        # (e) The analytic toy, drawn on the card.
        g = torch.Generator(device=device).manual_seed(SEED)
        x_a = torch.randn((TOY_FRAMES, TOY_D), generator=g, device=device,
                          dtype=torch.float64)
        x_s = TOY_SIGMA_S * torch.randn((TOY_FRAMES, TOY_D), generator=g,
                                        device=device, dtype=torch.float64)

        def toy_work(x):   # u_B(x) - u_A(x), the identity map's work
            return (x * x).sum(-1) * (0.5 / TOY_SIGMA_B2 - 0.5)

        def stat(d, vectorized=False, weights=None):
            return fep_estimator(d, vectorized=vectorized, weights=weights)

        toy = {}
        for label, data in (
                ('unbiased', toy_work(x_a)),
                ('biased', torch.stack([toy_work(x_s),
                                        -0.25 * (x_s * x_s).sum(-1)], -1)),
                ('unweighted', toy_work(x_s))):
            result = bootstrap(data, stat, n_resamples=ANALYSIS_RESAMPLES,
                               seed=1)
            toy[label] = dict(df=float(stat(data)), low=float(
                result['confidence_interval']['low']), high=float(
                result['confidence_interval']['high']))
        say(f'  (e) the identity-map toy, {TOY_FRAMES} frames per set drawn '
            f'on the card: analytic df -D ln(sigma_B) = {TOY_DF:.6f} kT; '
            + '; '.join(f'{k} {v["df"]:.6f} [{v["low"]:.6f}, {v["high"]:.6f}]'
                        for k, v in toy.items())
            + f'; the unweighted estimate\'s limit {TOY_WRONG_DF:.6f}')
        for label in ('unbiased', 'biased'):
            if not (toy[label]['low'] - TOY_SLACK <= TOY_DF
                    <= toy[label]['high'] + TOY_SLACK):
                raise AssertionError(f'(e) the {label} interval misses Δf')
        if not (abs(toy['unweighted']['df'] - TOY_WRONG_DF) < TOY_WRONG_TOL
                and abs(toy['unweighted']['df'] - TOY_DF) > TOY_MISS):
            raise AssertionError('(e) the unweighted estimate does not miss')
    finally:
        shutil.rmtree(work, ignore_errors=True)
    analysis = dict(df=estimate['df'],
                    confidence_interval=estimate['confidence_interval'],
                    df_float64=df64, max_diff=max(diffs), call_ms=call_ms,
                    bootstrap_ms=boot_ms, toy=toy, toy_df=TOY_DF)
    return dict(files=files, analysis=analysis, launches=launches,
                setup_s=file_map.setup_s, step_ms=step_ms,
                step_ms_without_logger=nolog_ms, window_ms=window_ms,
                busy_ms=busy_ms, idle_share=1.0 - busy_ms / step_ms,
                host_ms=host, read_ms=host['read'],
                mixed_read_ms=mixed_read, first_step_identical=first_same,
                all_losses_identical=all_losses_same,
                weights_identical=weights_same)


# ---------------------------------------------------------------------------
# Phase 13: the potentials bridge. Phase 9's CartesianMAFMap trained against
# a host engine through the autograd bridge, plainly and pipelined
# (Trainer(engine_overlap=True)).
# ---------------------------------------------------------------------------

# (b), (c): steps of the short runs; (c) the stopped run's last step;
# (e) Trainer.fit's steps between the two timed runs.
ENGINE_REPLAY_STEPS = 3
ENGINE_CRASH_STEP = 5
ENGINE_TIMED_STEPS = 10
ENGINE_POOL_WORKERS = 4
# (a) The engine computes 0.5 kT |y|^2 in float64 from the float32 y and
# returns float32; the torch potential computes it in float32: a few ulp
# of the energy (about 1e-7 relative). A unit or kT fault is off by a
# factor (4.184, 10, 100 or 600).
ENGINE_ENERGY_TOL = 1e-5
# (b) The first loss: phase 9's, where the engine's float64 energies
# round to float32 once more (APP_LOSS_TOL's reasoning).
ENGINE_LOSS_TOL = APP_LOSS_TOL
# (a) The loss gradients through -forces * g against autograd through the
# torch potential, per parameter tensor |g - g_ref| / |g_ref| (L2 norms):
# the same float32 flow backward fed a dL/dy that agrees to a few float32
# ulp per element; the chip runs of phase 13 measured 2.0e-7. A sign, unit
# or kT fault is off by 2, 3 or more.
ENGINE_BRIDGE_GRAD_TOL = 1e-5
# (c) The gradients that each pipelined step hands its optimizer
# (recorded at optimizer.step) against the plain step's and the replay's,
# per tensor as in (a): a tensor whose gradient is a batch sum that
# cancels (an output bias) keeps the rounding against a small norm, 1.4e-5
# for the pipelined step against the plain one (the second chip run of
# phase 13). A gradient at the wrong parameters is off by 1 (the layers
# behind the zero output gains of the first step have none there): (c)
# fails unless the undelayed gradients miss this tolerance.
ENGINE_GRAD_TOL = 1e-3
# (c) The weights after each such step. AdamW's first steps move a weight
# by lr m / (sqrt(v) + eps) (lr = 1e-4, eps = 1e-8), about lr times a sign
# where |g| is well above eps: a gradient element that is rounding noise
# (a sum over the batch that cancels to about 1e-7) takes a step of up to
# lr either way, so two runs that agree to float32 rounding may differ by
# up to 2 lr per step at such elements (the first chip run of phase 13:
# 9.9e-5 after one step). A tolerance of 2 lr per step.
ENGINE_WEIGHT_TOL = 2e-4


def harmonic_frame(k, positions, compute_forces):
    """One frame of the harmonic engine, in its units: ``positions`` in nm
    (float64, flattened), u = k |p|^2 in kJ/mol, forces -2 k p in kJ/mol/nm.
    Module level, so that a spawned pool worker unpickles it."""
    energy = k * float(np.dot(positions, positions))
    return energy, (-2.0 * k * positions if compute_forces else None)


def harmonic_engine(strategy=None, latency_s=0.0):
    """A host engine (``EnginePotential``) computing phase 9's potential
    u(y) = 0.5 kT |y|^2 (y in angstrom, u in kcal/mol at 300 K) in numpy
    float64, frame by frame through ``strategy``, in its own units of kJ/mol
    and nm: u = 50 kT |p|^2 with kT in kJ/mol. ``latency_s`` is a fixed
    host latency per batch (a stand-in for an engine's own time). Each
    call's ``compute_forces`` is recorded in ``calls``."""
    from tfep_tpu_torch.potentials import EnginePotential
    from tfep_tpu_torch.units import ureg

    class HarmonicEngine(EnginePotential):
        DEFAULT_ENERGY_UNIT = 'kilocalorie_per_mole'
        DEFAULT_POSITIONS_UNIT = 'angstrom'
        ENGINE_ENERGY_UNIT = 'kilojoule_per_mole'
        ENGINE_POSITIONS_UNIT = 'nanometer'

        def __init__(self):
            super().__init__(parallelization_strategy=strategy)
            self.k = 50.0 * float(ureg.kT(300.0 * ureg.kelvin,
                                          ureg.kilojoule_per_mole).magnitude)
            self.calls = []

        def _compute_batch(self, positions, cell, compute_forces):
            results = self.parallelization_strategy.run(
                harmonic_frame,
                [(self.k, p, compute_forces) for p in positions])
            if latency_s:
                time.sleep(latency_s)
            self.calls.append(compute_forces)
            energies = np.array([e for e, _ in results])
            return energies, (np.stack([f for _, f in results])
                              if compute_forces else None)

    return HarmonicEngine()


def copy_ms(y, n=20):
    """CUDA-event times of the pipeline's two copies at this batch: the
    mapped positions to pinned host memory, and the engine's energies and
    forces back to the card."""
    host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    back = [torch.empty(y.shape[:1], dtype=y.dtype, pin_memory=True),
            torch.empty(y.shape, dtype=y.dtype, pin_memory=True)]
    times = {}
    for name, copy in (
            ('to_host', lambda: host.copy_(y, non_blocking=True)),
            ('to_device', lambda: [t.to(y.device, non_blocking=True)
                                   for t in back])):
        copy()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            copy()
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end) / n
    return times


def weights_diff(a, b):
    """The largest |a - b| over two lists of tensors, and whether all are
    equal."""
    worst, same = 0.0, True
    for x, y in zip(a, b):
        worst = max(worst, float((x.detach() - y.detach()).abs().max()))
        same &= bool(torch.equal(x.detach(), y.detach()))
    return worst, same


def recording(grads, before=None):
    """An optimizer factory for ``Trainer``: ``default_optimizer`` whose
    ``step`` first appends a copy of each parameter's gradient to
    ``grads`` (and of the parameters it is about to update to
    ``before``)."""
    from tfep_tpu_torch.app.trainer import default_optimizer

    def factory(params):
        optimizer = default_optimizer(params)
        step = optimizer.step

        def recorded_step(*args, **kwargs):
            grads.append([p.grad.detach().clone() for p in params])
            if before is not None:
                before.append([p.detach().clone() for p in params])
            return step(*args, **kwargs)

        optimizer.step = recorded_step
        return optimizer

    return factory


def grads_diff(a, b):
    """The largest |a - b| / |b| (L2 norms, per tensor) over two lists of
    gradient tensors."""
    worst = 0.0
    for x, y in zip(a, b):
        diff, norm = float((x - y).norm()), float(y.norm())
        worst = max(worst, diff / norm if norm else diff)
    return worst


def engine_phase(device, smi, handoff):
    """Phase 13: checks (a)-(d) and the times (e). ``handoff`` holds phase
    8's untrained weights, phase 9's first loss and its step without the
    logger."""
    import copy as copying
    import multiprocessing
    import os
    import shutil
    import tempfile

    from tfep_tpu_torch.app import Trainer
    from tfep_tpu_torch.ops.spline import LAUNCHES
    from tfep_tpu_torch.parallel import ProcessPoolStrategy

    system = app_system()
    state = handoff['state']
    work = tempfile.mkdtemp(prefix='tfep_engine_')

    def new_map(name, potential, logger=True):
        return app_map(device, system, potential,
                       os.path.join(work, name, 'logs') if logger else None,
                       state)

    def params(tfep_map):
        return [p.detach().clone() for p in tfep_map.flow.parameters()]

    def counted_fit(trainer, tfep_map, **kwargs):
        torch.cuda.synchronize()
        LAUNCHES.reset()
        trainer.fit(tfep_map, **kwargs)
        torch.cuda.synchronize()
        return LAUNCHES.forward, LAUNCHES.backward

    try:
        # (a) The bridge on one batch at phase 8's untrained weights.
        engine = harmonic_engine()
        tfep_map = new_map('a', engine)
        torch_map = new_map('a_torch', HarmonicPotential())
        batch = tfep_map.batch_to_device(tfep_map.host_tensors(
            tfep_map.dataset.get_batch(np.arange(B))))
        with torch.no_grad():
            y = tfep_map.forward(batch)['positions']
            ours, theirs = engine(y), HarmonicPotential()(y)
        err, rel = rel_err(ours.double(), theirs.double())
        say(f'  {type(engine).__name__}(EnginePotential): kJ/mol and nm '
            f'inside, kcal/mol and angstrom outside, frame by frame in '
            f'numpy float64 on SerialStrategy; phase [9]\'s map with phase '
            f'[8]\'s weights, batch {B} (float32); {smi}')
        say(f'  (a) engine energies - torch potential\'s: max|diff| '
            f'{err:.3e}, {rel:.3e} of max(1, max|u|) (tolerance '
            f'{ENGINE_ENERGY_TOL:g}); {ours.dtype} on {ours.device}')
        if not (rel <= ENGINE_ENERGY_TOL and ours.dtype == torch.float32
                and ours.device == y.device):
            raise AssertionError('(a) the engine\'s energies differ')
        grads = []
        for m in (tfep_map, torch_map):
            m.flow.zero_grad(set_to_none=True)
            loss, _ = m.training_step_fn(m.flow, batch)
            loss.backward()
            grads.append([torch.zeros_like(p) if p.grad is None else p.grad
                          for p in m.flow.parameters()])
        worst, total, scale = 0.0, 0.0, 0.0
        for g_bridge, g_torch in zip(*grads):
            diff = float((g_bridge - g_torch).norm())
            norm = float(g_torch.norm())
            worst = max(worst, diff / norm if norm else diff)
            total, scale = total + diff ** 2, scale + norm ** 2
        with torch.no_grad():
            tfep_map.training_step_fn(tfep_map.flow, batch)
        say(f'  (a) loss gradients through -forces*g against autograd '
            f'through the torch potential, {len(grads[0])} parameter '
            f'tensors: largest |diff|/|g| per tensor {worst:.3e} (tolerance '
            f'{ENGINE_BRIDGE_GRAD_TOL:g}), over all '
            f'{(total / scale) ** 0.5:.3e}; engine calls (compute_forces): '
            f'{engine.calls} for an evaluation without grad, a loss with '
            f'grad, a loss without')
        if not worst <= ENGINE_BRIDGE_GRAD_TOL:
            raise AssertionError('(a) the bridge\'s gradient differs')
        grad_err = worst
        if engine.calls != [False, True, False]:
            raise AssertionError('(a) the engine was called with '
                                 f'{engine.calls}')
        y_host = y.cpu().numpy()
        del tfep_map, torch_map, batch, grads, y, ours, theirs

        # (b) Trainer.fit on the plain path: one step.
        plain_map = new_map('b', harmonic_engine())
        plain_grads = []
        plain = Trainer(save_dir=None, max_steps=1, shuffle=False,
                        optimizer=recording(plain_grads))
        plain_launches = counted_fit(plain, plain_map)
        ours, theirs = plain.loss_history[0], handoff['first_loss']
        diff = abs(ours - theirs) / max(1.0, abs(theirs))
        say(f'  (b) Trainer.fit, 1 step: K1/K2 launches {plain_launches}; '
            f'first loss {ours:.9g}, phase [9]\'s {theirs:.9g}: difference '
            f'{diff:.3e} of scale (tolerance {ENGINE_LOSS_TOL:g})')
        if plain_launches != (N_LAYERS, N_LAYERS):
            raise AssertionError(f'(b) K1/K2 launched {plain_launches}')
        if not (diff <= ENGINE_LOSS_TOL and np.isfinite(ours)):
            raise AssertionError('(b) the first loss differs')
        one_step = params(plain_map)
        del plain_map, plain

        # (c) Trainer.fit(engine_overlap=True): one step against (b).
        pipe_map = new_map('c1', harmonic_engine())
        pipe_grads = []
        pipe = Trainer(save_dir=None, max_steps=1, shuffle=False,
                       engine_overlap=True, optimizer=recording(pipe_grads))
        one_launches = counted_fit(pipe, pipe_map)
        grad_one = grads_diff(pipe_grads[0], plain_grads[0])
        worst, same = weights_diff(params(pipe_map), one_step)
        say(f'  (c) one pipelined step: K1/K2 launches {one_launches}; its '
            f'gradients against (b)\'s: largest |diff|/|g| per tensor '
            f'{grad_one:.3e} (tolerance {ENGINE_GRAD_TOL:g}); weights: '
            f'max|diff| {worst:.3e} (tolerance {ENGINE_WEIGHT_TOL:g}), '
            f'bit-identical: {same}; loss {pipe.loss_history[0]:.9g}')
        if one_launches != (2 * N_LAYERS, N_LAYERS):
            raise AssertionError(f'(c) K1/K2 launched {one_launches}')
        if not (grad_one <= ENGINE_GRAD_TOL
                and worst <= ENGINE_WEIGHT_TOL):
            raise AssertionError('(c) one pipelined step differs from the '
                                 'plain step')
        pipe_one = params(pipe_map)
        del pipe_map, pipe, plain_grads, pipe_grads

        # (c) Three pipelined steps. Each update's gradient against the
        # standard loss's (through the bridge) at the parameters of the
        # step before, recorded in the run (the contract), and at those of
        # its own step (an undelayed update); then the weights against a
        # free-running replay with delayed gradients
        # (tests/app/test_pipeline.py:77-143).
        pipe_map = new_map('c3', harmonic_engine())
        pipe_grads, pipe_before = [], []
        Trainer(save_dir=None, max_steps=ENGINE_REPLAY_STEPS, shuffle=False,
                engine_overlap=True,
                optimizer=recording(pipe_grads, pipe_before)).fit(pipe_map)
        pipelined = params(pipe_map)
        del pipe_map
        replay_map = new_map('replay', harmonic_engine())
        flow = replay_map.flow
        trainable = [p for p in flow.parameters() if p.requires_grad]
        batches = [replay_map.batch_to_device(replay_map.host_tensors(
            replay_map.dataset.get_batch(np.arange(k * B, (k + 1) * B))))
            for k in range(ENGINE_REPLAY_STEPS)]

        def gradient_at(values, batch):
            with torch.no_grad():
                for p, value in zip(trainable, values):
                    p.copy_(value)
            flow.zero_grad(set_to_none=True)
            loss, _ = replay_map.training_step_fn(flow, batch)
            loss.backward()
            return [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                    for p in trainable]

        grad_delayed = max(
            grads_diff(pipe_grads[k], gradient_at(
                pipe_before[max(0, k - 1)], batches[k]))
            for k in range(ENGINE_REPLAY_STEPS))
        grad_undelayed = max(
            grads_diff(pipe_grads[k], gradient_at(pipe_before[k], batches[k]))
            for k in range(1, ENGINE_REPLAY_STEPS))
        with torch.no_grad():
            for p, value in zip(trainable, pipe_before[0]):
                p.copy_(value)
        optimizer = recording([])(trainable)
        history = [params(replay_map)]
        for k in range(ENGINE_REPLAY_STEPS):
            snap = copying.deepcopy(flow)
            with torch.no_grad():
                for p, value in zip(snap.parameters(),
                                    history[max(0, k - 1)]):
                    p.copy_(value)
            loss, _ = replay_map.training_step_fn(snap, batches[k])
            loss.backward()
            for p, q in zip(trainable, [q for q in snap.parameters()
                                        if q.requires_grad]):
                p.grad = torch.zeros_like(p) if q.grad is None else q.grad
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            history.append(params(replay_map))
            del snap, loss
        worst, same = weights_diff(pipelined, history[-1])
        say(f'  (c) {ENGINE_REPLAY_STEPS} pipelined steps: each update\'s '
            f'gradient against the standard loss\'s at the parameters of '
            f'the step before (recorded in the run): largest |diff|/|g| '
            f'per tensor {grad_delayed:.3e} (tolerance '
            f'{ENGINE_GRAD_TOL:g}); at its own step\'s parameters '
            f'(undelayed) {grad_undelayed:.3e}; final weights against a '
            f'replay with delayed gradients: max|diff| {worst:.3e} '
            f'(tolerance {ENGINE_REPLAY_STEPS * ENGINE_WEIGHT_TOL:g}), '
            f'bit-identical: {same}')
        if not (grad_delayed <= ENGINE_GRAD_TOL < grad_undelayed
                and worst <= ENGINE_REPLAY_STEPS * ENGINE_WEIGHT_TOL):
            raise AssertionError('(c) the pipelined steps are not the '
                                 'delayed replay')
        del (pipe_grads, pipe_before, replay_map, flow, trainable, batches,
             optimizer, history)

        # (c) Two epochs pipelined: launches, finite losses, log rows in
        # the sampler's order; then a run stopped at step 5 and resumed.
        full_map = new_map('c', harmonic_engine())
        full = Trainer(save_dir=os.path.join(work, 'c', 'ckpt'),
                       max_epochs=APP_EPOCHS, shuffle=True, shuffle_seed=0,
                       engine_overlap=True,
                       checkpoint_every_n_steps=ENGINE_CRASH_STEP)
        pipe_launches = counted_fit(full, full_map)
        losses = np.asarray(full.loss_history)
        say(f'  (c) Trainer(max_epochs={APP_EPOCHS}, shuffle_seed=0, '
            f'engine_overlap=True): {full.global_step} steps, K1/K2 launches '
            f'{pipe_launches} ({pipe_launches[0] / full.global_step:g}/'
            f'{pipe_launches[1] / full.global_step:g} per step); losses '
            f'{losses[0]:.6g} -> {losses[-1]:.6g}; engine calls '
            f'{len(full_map._potential_energy_func.calls)}, all with forces: '
            f'{all(full_map._potential_energy_func.calls)}')
        if full.global_step != APP_STEPS or len(losses) != APP_STEPS:
            raise AssertionError('(c) the trainer did not take 20 steps')
        if pipe_launches != (2 * N_LAYERS * APP_STEPS, N_LAYERS * APP_STEPS):
            raise AssertionError(f'(c) K1/K2 launched {pipe_launches}')
        if not np.all(np.isfinite(losses)):
            raise AssertionError('(c) a loss is not finite')
        calls = full_map._potential_energy_func.calls
        if calls != [True] * APP_STEPS:
            raise AssertionError(f'(c) the engine was called {calls}')
        logger = full_map.tfep_logger
        for step, indices in enumerate(app_orders(0, APP_EPOCHS)):
            rows = logger.read_train_tensors(step_idx=step)
            if not (np.array_equal(rows['dataset_sample_index'], indices)
                    and np.all(np.isfinite(rows['potential']))
                    and np.all(np.isfinite(rows['log_det_J']))):
                raise AssertionError(f'(c) step {step} lacks its log rows')
        say(f'  (c) every step\'s {B} rows in tfep_logger.read_train_tensors'
            f', in the sampler\'s order for shuffle_seed=0, finite')
        trained = params(full_map)
        del full_map, full

        stopped = Trainer(save_dir=os.path.join(work, 'd', 'ckpt'),
                          max_steps=ENGINE_CRASH_STEP, shuffle=True,
                          shuffle_seed=0, engine_overlap=True,
                          checkpoint_every_n_steps=ENGINE_CRASH_STEP)
        stopped.fit(new_map('d', harmonic_engine()))
        resumed_map = new_map('d', harmonic_engine())
        resumed = Trainer(save_dir=os.path.join(work, 'd', 'ckpt'),
                          max_epochs=APP_EPOCHS, shuffle=True, shuffle_seed=0,
                          engine_overlap=True,
                          checkpoint_every_n_steps=ENGINE_CRASH_STEP)
        resumed.fit(resumed_map, resume=True)
        rows = resumed_map.tfep_logger.read_train_tensors(epoch_idx=0)
        worst, same = weights_diff(params(resumed_map), trained)
        say(f'  (c) stopped at step {ENGINE_CRASH_STEP} (the checkpoint '
            f'keeps the next batch\'s snapshot), resumed: '
            f'{len(resumed.loss_history)} more steps, epoch 0\'s '
            f'{APP_FRAMES} samples each logged once; final weights against '
            f'the uninterrupted run: max|diff| {worst:.3e} (tolerance '
            f'{APP_RESUME_TOL:g}), bit-identical: {same}')
        if not (resumed.global_step == APP_STEPS
                and len(resumed.loss_history) == APP_STEPS - ENGINE_CRASH_STEP
                and np.array_equal(np.sort(rows['dataset_sample_index']),
                                   np.arange(APP_FRAMES))):
            raise AssertionError('(c) the resumed run does not cover epoch 0 '
                                 'once')
        if not worst <= APP_RESUME_TOL:
            raise AssertionError('(c) the resumed weights differ')
        del resumed_map, resumed, stopped, trained

        # (d) A spawn pool of 4 workers, made after CUDA has initialized.
        serial = harmonic_engine()
        t0 = time.perf_counter()
        e_serial, f_serial = serial.compute_energies_and_forces(y_host)
        serial_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        with multiprocessing.get_context('spawn').Pool(
                ENGINE_POOL_WORKERS) as pool:
            start_s = time.perf_counter() - t0
            pooled = harmonic_engine(ProcessPoolStrategy(pool))
            pooled.compute_energies_and_forces(y_host)   # warm the workers
            t0 = time.perf_counter()
            e_pool, f_pool = pooled.compute_energies_and_forces(y_host)
            pool_ms = 1e3 * (time.perf_counter() - t0)
            pool_map = new_map('d_pool', pooled)
            pool_trainer = Trainer(save_dir=None, max_steps=1, shuffle=False,
                                   engine_overlap=True)
            pool_trainer.fit(pool_map)
            pool_step, pool_same = weights_diff(params(pool_map), pipe_one)
            del pool_map
        same = (np.array_equal(e_serial, e_pool)
                and np.array_equal(f_serial, f_pool))
        say(f'  (d) ProcessPoolStrategy over a spawn pool of '
            f'{ENGINE_POOL_WORKERS} workers (started in {start_s:.2f} s, '
            f'after CUDA): energies and forces of {B} frames bit-identical '
            f'to SerialStrategy\'s: {same} (pool {pool_ms:.1f} ms, serial '
            f'{serial_ms:.1f} ms, {e_pool.dtype}); one pipelined step on the '
            f'pool against (c)\'s: max|diff| {pool_step:.3e}, bit-identical:'
            f' {pool_same}')
        if not same:
            raise AssertionError('(d) the pool\'s results differ')
        if not pool_same:
            raise AssertionError('(d) the pool\'s step differs')

        # (e) Times, with the engine given a fixed host latency per batch:
        # phase 9's step without the logger, measured in this run.
        latency_s = handoff['step_ms_without_logger'] / 1e3
        slow = harmonic_engine(latency_s=latency_s)
        engine_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            slow.compute_energies_and_forces(y_host)
            engine_ms.append(1e3 * (time.perf_counter() - t0))
        engine_ms = float(np.median(engine_ms))
        copies = copy_ms(torch.as_tensor(y_host, device=device))
        walls, host, launches = {}, {}, {}
        for overlap in (False, True):
            for steps in (ENGINE_TIMED_STEPS, 2 * ENGINE_TIMED_STEPS):
                tfep_map = new_map('e', harmonic_engine(latency_s=latency_s),
                                   logger=False)
                timed = Trainer(save_dir=None, max_steps=steps, shuffle=True,
                                shuffle_seed=0, engine_overlap=overlap)
                t0 = time.perf_counter()
                launches[overlap] = counted_fit(timed, tfep_map)
                walls[overlap, steps] = time.perf_counter() - t0
                host[overlap] = {name: 1e3 * total / calls for name, (
                    total, calls) in timed.host_seconds.items()}
                del tfep_map, timed
        step_ms = {overlap: 1e3 * (walls[overlap, 2 * ENGINE_TIMED_STEPS]
                                   - walls[overlap, ENGINE_TIMED_STEPS])
                   / ENGINE_TIMED_STEPS for overlap in (False, True)}
        busy_ms, window_ms = {}, {}
        for overlap in (False, True):
            tfep_map = new_map('e', harmonic_engine(latency_s=latency_s),
                               logger=False)
            profiled = Trainer(save_dir=None, max_steps=9, shuffle=True,
                               shuffle_seed=0, engine_overlap=overlap,
                               profile_dir=os.path.join(work, 'e', 'prof'),
                               profile_steps=(3, 8))
            profiled.fit(tfep_map)
            window = profiled.profiled_step_times
            kinds = kernel_kinds(profiled.profile)
            busy_ms[overlap] = (sum(us for _, us in kinds.values())
                                / len(window) / 1e3)
            window_ms[overlap] = 1e3 * sum(window) / len(window)
            del tfep_map, profiled
        rest_ms = step_ms[False] - engine_ms
        say(f'  (e) engine latency {latency_s * 1e3:.3f} ms per batch '
            f'(phase [9]\'s step without the logger in this run); the engine '
            f'alone {engine_ms:.3f} ms per batch of {B} (latency + '
            f'{engine_ms - latency_s * 1e3:.3f} ms of numpy, frame by frame);'
            f' copies: positions to pinned host {copies["to_host"]:.4f} ms, '
            f'energies and forces to the card {copies["to_device"]:.4f} ms '
            f'(CUDA events); {smi}')
        for overlap, label in ((False, 'plain'), (True, 'pipelined')):
            say(f'  (e) {label} Trainer.fit step without the logger: '
                f'{step_ms[overlap]:.3f} ms ((fit of {2 * ENGINE_TIMED_STEPS} '
                f'steps - fit of {ENGINE_TIMED_STEPS}) / {ENGINE_TIMED_STEPS})'
                f', {B / step_ms[overlap] * 1e3:.0f} frames/s; device busy '
                f'{busy_ms[overlap]:.3f} ms per step (profiled window of 5 '
                f'steps, {window_ms[overlap]:.3f} ms per step there), idle '
                f'share {1.0 - busy_ms[overlap] / step_ms[overlap]:.3f}; '
                f'K1/K2 {launches[overlap]} in {2 * ENGINE_TIMED_STEPS} '
                f'steps; host ms per call: ' + ', '.join(
                    f'{name} {ms:.3f}' for name, ms in host[overlap].items()))
        say(f'  (e) pipelined / plain {step_ms[True] / step_ms[False]:.3f}; '
            f'max(engine, rest) {max(engine_ms, rest_ms):.3f} ms, engine + '
            f'rest {step_ms[False]:.3f} ms (rest = plain step - engine = '
            f'{rest_ms:.3f} ms); {smi}')
        if launches[False] != (2 * ENGINE_TIMED_STEPS * N_LAYERS,) * 2 or \
                launches[True] != (4 * ENGINE_TIMED_STEPS * N_LAYERS,
                                   2 * ENGINE_TIMED_STEPS * N_LAYERS):
            raise AssertionError(f'(e) K1/K2 launched {launches}')
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(launches=plain_launches, pipelined_launches=pipe_launches,
                energy_rel_err=rel, grad_rel_err=grad_err,
                engine_ms=engine_ms, latency_ms=latency_s * 1e3,
                copy_ms=copies, step_ms=step_ms[False],
                pipelined_step_ms=step_ms[True], busy_ms=busy_ms[False],
                pipelined_busy_ms=busy_ms[True],
                idle_share=1.0 - busy_ms[False] / step_ms[False],
                pipelined_idle_share=1.0 - busy_ms[True] / step_ms[True],
                host_ms=host[False], pipelined_host_ms=host[True],
                pool_ms=pool_ms, serial_ms=serial_ms)


# ---------------------------------------------------------------------------
# Phase 14: vmapped ensembles at benchmarks/ensemble_bench.py's
# configuration, and mixed-precision products (compute_dtype='bfloat16').
# ---------------------------------------------------------------------------

ENSEMBLE_BATCH = 256
ENSEMBLE_MEMBERS = (1, 2, 4, 8, 16)
ENSEMBLE_PROFILED = (1, 16)
ENSEMBLE_CHECKED = 4
ENSEMBLE_COUNTED_STEPS = 3
ENSEMBLE_TIMED_STEPS = 20
# (a) Each member of the ensemble against the member trained alone, on the
# card: the same float32 products, batched over the members (cuBLAS's
# batched kernels) or not, may sum in another order. The first loss: a
# few float32 ulp of a sum over 256 frames and 96 features.
ENSEMBLE_LOSS_TOL = 1e-6
# The first step's gradients, per tensor as ENGINE_GRAD_TOL's: a tensor
# whose gradient is a batch sum that cancels keeps the rounding against a
# small norm (1.4e-5 in phase 13). A gradient of the wrong member or of
# another batch is off by about 1.
ENSEMBLE_GRAD_TOL = 1e-4
# The weights after ENSEMBLE_COUNTED_STEPS steps: ENGINE_WEIGHT_TOL per
# step (AdamW moves an element whose gradient is rounding noise by up to
# lr either way).
# (b) The bf16 flow against the float32 flow on the same weights, relative
# to max(1, max|float32|): each product's operands are rounded to 8
# significant bits (2^-9 relative), over three products per layer and six
# layers; the JAX package's one-layer test allows 5% (tests/nn/flows/
# test_maf.py).
BF16_MAP_TOL = 0.1
# The card's bf16 product against the exact rule (the float32 product of
# the rounded operands) on the same inputs: forward, the same products
# summed in another order (float32 order, relative to the scale); the
# operand gradients, where the card also rounds the cotangent to bf16
# (2^-9 relative per term) and both round the result once more: 2^-7 of
# the scale.
BF16_PRODUCT_TOL = 1e-5
BF16_PRODUCT_GRAD_TOL = 2.0 ** -7


def ensemble_loss(flow, x):
    """``mean(0.5 |y|^2 - log_det_J)``: ensemble_bench's loss."""
    from tfep_tpu_torch.loss import boltzmann_kl_div_loss
    y, ldj = flow(x)
    return boltzmann_kl_div_loss(0.5 * torch.sum(y * y, dim=-1), ldj)


def folded_kernel_check(device):
    """K1/K2 under ``vmap`` over ENSEMBLE_CHECKED members (one launch each
    on the folded rows) against the plain version on the same rows."""
    from tfep_tpu_torch.ops import spline as fs
    k, b = ENSEMBLE_CHECKED, ENSEMBLE_BATCH
    x, params, *bounds = spline_inputs(False, device, 5)
    # Half the rows inside the domain, half outside, as phase 2's.
    rows = torch.cat([torch.arange(k * b // 2),
                      torch.arange(B - k * b // 2, B)]).to(device)
    x, params = x[rows].reshape(k, b, F), params[rows].reshape(k, b, -1)
    g = torch.Generator().manual_seed(6)
    gy, gl = (torch.randn(k, b, F, generator=g).to(device) for _ in range(2))

    def member(xx, pp):
        return fs.fused_spline(xx, pp, *bounds, K)

    before = (fs.LAUNCHES.forward, fs.LAUNCHES.backward)
    outs, vjp = torch.func.vjp(torch.func.vmap(member), x, params)
    grads = vjp((gy, gl))
    launched = (fs.LAUNCHES.forward - before[0],
                fs.LAUNCHES.backward - before[1])
    xi = x.reshape(k * b, F).clone().requires_grad_()
    pi = params.reshape(k * b, -1).clone().requires_grad_()
    plain = fs.fused_spline_reference(xi, pi, *bounds, K)
    plain_grads = torch.autograd.grad(plain, (xi, pi), (gy.reshape(k * b, F),
                                                        gl.reshape(k * b, F)))
    torch.cuda.synchronize()
    errors = {}
    for label, kern, ref, tol in (
            ('y', outs[0], plain[0], FORWARD_TOL),
            ('dl', outs[1], plain[1], FORWARD_TOL),
            ('grad_x', grads[0], plain_grads[0], BACKWARD_TOL),
            ('grad_params', grads[1], plain_grads[1], BACKWARD_TOL)):
        err, rel = rel_err(kern.reshape(ref.shape), ref.detach())
        say(f'  (a) folded K1/K2, {k} members x {b} rows, {label}: '
            f'max|kernel-plain| = {err:.3e} (relative to scale {rel:.3e}, '
            f'tolerance {tol:g})')
        if not (torch.isfinite(kern).all() and rel <= tol):
            raise AssertionError(f'(a) the folded {label} disagrees')
        key = 'forward' if tol == FORWARD_TOL else 'backward'
        errors[key] = max(errors.get(key, 0.0), err)
    say(f'  (a) one vmapped call over {k} members launched K1/K2 '
        f'{launched} times on ({k * b}, {F}) rows')
    if launched != (1, 1):
        raise AssertionError(f'(a) the folded call launched {launched}')
    return errors


def ensemble_phase(device, smi):
    """Phase 14 (a): the ensemble step at ensemble_bench's configuration
    for each K, the members at K = ENSEMBLE_CHECKED against the members
    trained alone, and the folded kernels against their plain version."""
    from tfep_tpu_torch.app.trainer import default_optimizer
    from tfep_tpu_torch.nn.ensemble import (
        ensemble_init, make_ensemble_train_step, stack_modules,
        unstack_module,
    )
    from tfep_tpu_torch.ops.spline import LAUNCHES

    errors = folded_kernel_check(device)
    members = [build_slice(device, seed=SEED + 1 + i,
                           batch=ENSEMBLE_BATCH)[0]
               for i in range(max(ENSEMBLE_MEMBERS))]
    frames = torch.randn(ENSEMBLE_BATCH, F, generator=torch.Generator(
        ).manual_seed(SEED + 100)).to(device)
    n_params = sum(p.numel() for p in members[0].parameters())
    say(f'  {max(ENSEMBLE_MEMBERS)} members of phase [3]\'s flow '
        f'({n_params} parameters each), batch {ENSEMBLE_BATCH} shared, '
        f'AdamW (lr 1e-4, decay 1e-4)')

    # The members at K = ENSEMBLE_CHECKED against each member alone.
    k = ENSEMBLE_CHECKED
    stacked = stack_modules(members[:k])
    stacked_grads = []
    step = make_ensemble_train_step(ensemble_loss, ensemble_init(
        recording(stacked_grads), stacked))
    ens_losses = [step(stacked, frames) for _ in range(ENSEMBLE_COUNTED_STEPS)]
    worst = dict(loss=0.0, grad=0.0, weights=0.0)
    for i in range(k):
        alone = copy.deepcopy(members[i])
        alone_grads = []
        optimizer = recording(alone_grads)(list(alone.parameters()))
        first = None
        for _ in range(ENSEMBLE_COUNTED_STEPS):
            optimizer.zero_grad(set_to_none=True)
            loss = ensemble_loss(alone, frames)
            loss.backward()
            optimizer.step()
            first = float(loss.detach()) if first is None else first
        ours = float(ens_losses[0][i])
        worst['loss'] = max(worst['loss'],
                            abs(ours - first) / max(1.0, abs(first)))
        worst['grad'] = max(worst['grad'], grads_diff(
            [g[i] for g in stacked_grads[0]], alone_grads[0]))
        worst['weights'] = max(worst['weights'], weights_diff(
            list(unstack_module(stacked, i).parameters()),
            list(alone.parameters()))[0])
        del alone, optimizer, alone_grads
    weight_tol = ENSEMBLE_COUNTED_STEPS * ENGINE_WEIGHT_TOL
    say(f'  (a) K={k}, each member against itself trained alone on the '
        f'card: first loss {worst["loss"]:.3e} of scale (tolerance '
        f'{ENSEMBLE_LOSS_TOL:g}); first step\'s gradients, largest '
        f'|diff|/|g| per tensor {worst["grad"]:.3e} (tolerance '
        f'{ENSEMBLE_GRAD_TOL:g}); weights after {ENSEMBLE_COUNTED_STEPS} '
        f'steps max|diff| {worst["weights"]:.3e} (tolerance '
        f'{weight_tol:g})')
    if not (worst['loss'] <= ENSEMBLE_LOSS_TOL
            and worst['grad'] <= ENSEMBLE_GRAD_TOL
            and worst['weights'] <= weight_tol):
        raise AssertionError('(a) an ensemble member differs from the '
                             'member trained alone')
    del stacked, step, stacked_grads
    torch.cuda.empty_cache()

    rows, launches = [], [0, 0]
    for k in ENSEMBLE_MEMBERS:
        stacked = stack_modules(members[:k])
        step = make_ensemble_train_step(ensemble_loss, ensemble_init(
            default_optimizer, stacked))

        def run():
            return step(stacked, frames)

        # The main path, counted.
        LAUNCHES.reset()
        losses = [run() for _ in range(ENSEMBLE_COUNTED_STEPS)]
        counted = (LAUNCHES.forward, LAUNCHES.backward)
        launches[0] += counted[0]
        launches[1] += counted[1]
        per_step = (counted[0] / ENSEMBLE_COUNTED_STEPS,
                    counted[1] / ENSEMBLE_COUNTED_STEPS)
        if per_step != (N_LAYERS, N_LAYERS):
            raise AssertionError(f'(a) K={k}: K1/K2 launched {counted} in '
                                 f'{ENSEMBLE_COUNTED_STEPS} steps')
        last = torch.stack(losses)
        if not (last.shape == (ENSEMBLE_COUNTED_STEPS, k)
                and torch.isfinite(last).all()):
            raise AssertionError(f'(a) K={k}: losses {last}')

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        for _ in range(ENSEMBLE_TIMED_STEPS):
            run()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3 / ENSEMBLE_TIMED_STEPS
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / ENSEMBLE_TIMED_STEPS
        peak = torch.cuda.max_memory_allocated()
        row = dict(members=k, step_ms=step_ms, host_enqueue_ms=host_ms,
                   member_steps_per_s=k / step_ms * 1e3,
                   peak_bytes=peak, launches_per_step=per_step,
                   busy_ms=None)
        if k in ENSEMBLE_PROFILED:
            row['busy_ms'] = profile_phase(run, step_ms, smi, n=5,
                                           batch=ENSEMBLE_BATCH)
        rows.append(row)
        say(f'  (a) K={k}: step {step_ms:.3f} ms (CUDA events over '
            f'{ENSEMBLE_TIMED_STEPS} steps; host enqueue {host_ms:.3f} ms), '
            f'{row["member_steps_per_s"]:.1f} member-steps/s '
            f'({row["member_steps_per_s"] / rows[0]["member_steps_per_s"]:.2f}'
            f'x K=1), peak memory {peak / 2**20:.1f} MiB, K1/K2 per step '
            f'{per_step[0]:g}/{per_step[1]:g}; first losses '
            f'{[round(float(v), 4) for v in losses[0][:4]]}; [{smi}]')
        del stacked, step, losses
        torch.cuda.empty_cache()
    return dict(rows=rows, checks=worst, errors=errors,
                launches=tuple(launches))


def bf16_product_check(device, layer):
    """The card's bf16 product (``low_precision_matmul`` on CUDA tensors)
    against the exact rule run on the card, at one of the MAF's products:
    the float32 product of the rounded operands, and each operand's
    gradient the float32 product of the float32 cotangent with the other
    rounded operand, rounded once to bf16."""
    from tfep_tpu_torch.nn.masked import low_precision_matmul
    g = torch.Generator().manual_seed(7)
    w = layer.effective_weight().detach()
    x = torch.randn(B, w.shape[1], generator=g).to(device)
    gy = torch.randn(B, w.shape[0], generator=g).to(device)
    xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = low_precision_matmul(xi, wi, 'bfloat16')
    gx, gw = torch.autograd.grad(y, (xi, wi), gy)
    bf = torch.bfloat16
    xr, wr = x.to(bf).float(), w.to(bf).float()
    errors = {}
    for label, card, exact, tol in (
            ('y', y, xr @ wr.T, BF16_PRODUCT_TOL),
            ('grad_x', gx, (gy @ wr).to(bf).float(), BF16_PRODUCT_GRAD_TOL),
            ('grad_w', gw, (gy.T @ xr).to(bf).float(),
             BF16_PRODUCT_GRAD_TOL)):
        err, rel = rel_err(card.detach(), exact)
        errors['product_' + label] = rel
        say(f'  (b) bf16 product ({B}x{w.shape[1]} @ {w.shape[1]}x'
            f'{w.shape[0]}) on the card against the exact rule, {label}: '
            f'max|diff| = {err:.3e} (relative to scale {rel:.3e}, '
            f'tolerance {tol:g})')
        if not rel <= tol:
            raise AssertionError(f'(b) the bf16 product\'s {label} '
                                 'disagrees')
    return errors


def bf16_phase(device, smi, handoff):
    """Phase 14 (b): phase 3's MAF with compute_dtype='bfloat16' on phase
    3's weights, against the float32 flow; then cnf_bench's EGNN field on
    the dense path. ``handoff`` holds phase [3]'s float32 step, busy time
    and profile."""
    from tfep_tpu_torch.app.trainer import default_optimizer
    from tfep_tpu_torch.nn.dynamics import EGNNDynamics
    from tfep_tpu_torch.ops.spline import LAUNCHES

    flow32, frames = build_slice(device)
    flow, _ = build_slice(device, compute_dtype='bfloat16')
    flow.load_state_dict(flow32.state_dict())
    with torch.no_grad():
        y32, ldj32 = flow32(frames)
        y16, ldj16 = flow(frames)
    loss32 = float(torch.mean(0.5 * torch.sum(y32 * y32, dim=-1) - ldj32))
    loss16 = float(torch.mean(0.5 * torch.sum(y16 * y16, dim=-1) - ldj16))
    del flow32
    errors = {}
    for label, a, b in (('y', y16, y32), ('log_det_J', ldj16, ldj32)):
        err, errors[label] = rel_err(a, b)
        say(f'  (b) bf16 flow against float32, {label}: max|diff| = '
            f'{err:.3e} (relative to scale {errors[label]:.3e}, tolerance '
            f'{BF16_MAP_TOL:g})')
    errors['loss'] = abs(loss16 - loss32) / max(1.0, abs(loss32))
    say(f'  (b) loss {loss16:.6f} against float32 {loss32:.6f}: '
        f'{errors["loss"]:.3e} of scale (tolerance {BF16_MAP_TOL:g})')
    if not (y16.dtype == torch.float32 and all(
            v <= BF16_MAP_TOL for v in errors.values())):
        raise AssertionError('(b) the bf16 flow is off the float32 flow')

    optimizer = default_optimizer(list(flow.parameters()))

    def train_step():
        optimizer.zero_grad(set_to_none=True)
        loss = ensemble_loss(flow, frames)
        loss.backward()
        optimizer.step()
        return loss

    # The main path, counted.
    LAUNCHES.reset()
    losses = [float(train_step().detach()) for _ in range(N_STEPS)]
    launches = (LAUNCHES.forward, LAUNCHES.backward)
    say(f'  (b) {N_STEPS} bf16 training steps, loss {losses}; K1/K2 '
        f'launches {launches}')
    if launches != (N_STEPS * N_LAYERS, N_STEPS * N_LAYERS) or not np.all(
            np.isfinite(losses)):
        raise AssertionError(f'(b) K1/K2 launched {launches}, losses '
                             f'{losses}')
    round_trip(flow, frames, '(b) bf16 round trip')
    times = step_times(flow, frames, train_step, smi)
    kinds = {}
    busy = profile_phase(train_step, times['step_ms'], smi, kinds_out=kinds)
    cublas = 'matrix products (cuBLAS)'
    ref_kinds = handoff['kinds']
    say(f'  (b) bf16 against float32 (phase [3], same run): step '
        f'{times["step_ms"]:.3f} / {handoff["step_ms"]:.3f} ms; device busy '
        f'{busy:.3f} / {handoff["busy_ms"]:.3f} ms; cuBLAS '
        f'{kinds.get(cublas, (0, 0.0))[1]:.3f} ms in '
        f'{kinds.get(cublas, (0, 0.0))[0]:.0f} kernels / '
        f'{ref_kinds.get(cublas, (0, 0.0))[1]:.3f} ms in '
        f'{ref_kinds.get(cublas, (0, 0.0))[0]:.0f} kernels; [{smi}]')
    errors.update(bf16_product_check(
        device, flow[0].conditioner.layers[1]))
    del flow, optimizer, train_step
    torch.cuda.empty_cache()

    # cnf_bench's field on the dense path, without grad.
    fields = {}
    for name, compute_dtype in (('float32', None), ('bfloat16', 'bfloat16')):
        dynamics = EGNNDynamics.create(
            torch.Generator().manual_seed(SEED), node_types=np.arange(
                N_ATOMS) % 4, r_cutoff=R_CUTOFF, time_feat_dim=16,
            node_feat_dim=CNF_FEAT, distance_feat_dim=CNF_FEAT,
            n_layers=CNF_LAYERS, initialize_identity=False, device=device,
            compute_dtype=compute_dtype)
        if name == 'bfloat16':
            dynamics.load_state_dict(state)
        state = dynamics.state_dict()
        x = 0.5 * torch.randn(CNF_BATCH, 3 * N_ATOMS, generator=torch.
                              Generator().manual_seed(SEED + 1)).to(device)
        with torch.no_grad():
            fields[name] = dynamics(0.5, x)
    err, errors['egnn_field'] = rel_err(fields['bfloat16'], fields['float32'])
    say(f'  (b) cnf_bench\'s EGNN field (dense, batch {CNF_BATCH}, no grad), '
        f'bf16 against float32: max|diff| = {err:.3e} (relative to scale '
        f'{errors["egnn_field"]:.3e}, tolerance {BF16_MAP_TOL:g})')
    if not errors['egnn_field'] <= BF16_MAP_TOL:
        raise AssertionError('(b) the bf16 EGNN field is off float32\'s')
    return dict(times, busy_ms=busy, kinds=kinds, errors=errors,
                launches=launches, losses=losses)


# ---------------------------------------------------------------------------
# Phase 15: multi-process training (parallel/{distributed,sharding}): one
# rank over NCCL, two ranks on the one card over gloo, and the fused EGNN
# field as a vmapped ensemble.
# ---------------------------------------------------------------------------

# (a) and (b)(i): three global batches of phase 9's configuration.
PARALLEL_STEPS = 3
PARALLEL_FRAMES = PARALLEL_STEPS * B
PARALLEL_RANKS = 2
# (a) Steps between the two timed fits whose difference times a step.
PARALLEL_TIMED_STEPS = 10
PARALLEL_TIMEOUT_S = 300
# (a) The sharded fit on one rank against the unsharded fit: the same
# float32 operations in the same order, and an all-reduce of one rank
# that copies (and divides by 1), so bit-identical is expected; 1e-6 of
# the scale leaves room only for a library reduction that sums in another
# order on another call.
PARALLEL_NCCL_TOL = 1e-6
# (b)(i) Two ranks at 2048 rows each against one process at 4096 on the
# same global batches: each rank's mean over 2048 frames, averaged over
# the ranks, sums in another order than one mean over 4096 (a few float32
# ulp). The loss as APP_LOSS_TOL; the first step's gradients per tensor
# as ENSEMBLE_GRAD_TOL; the weights after the steps ENGINE_WEIGHT_TOL per
# step (AdamW moves a weight whose gradient is rounding noise by up to lr
# either way).
PARALLEL_WEIGHT_TOL = PARALLEL_STEPS * ENGINE_WEIGHT_TOL
# (b)(ii) tp = 2 against the replicated flow: the row-parallel layer adds
# two partial products of 239 terms where cuBLAS sums 478 in one, and its
# weight norm two partial sums of squares: forward as MAP_TOL (of
# max(1, max|y|)). The gradients are held against a float64 copy of the
# replicated flow (plain spline path), beside the replicated float32
# flow's own error: a tensor whose gradient is a batch sum that cancels
# (an output bias) keeps float32 rounding against a small norm, 1.4e-3 of
# it in the first chip run. Per tensor, the split flow's error may be
# TP_GRAD_FACTOR times the replicated flow's own, plus ENSEMBLE_GRAD_TOL
# of the norm; a missing or doubled all-reduce is off by about the norm.
# The weights after one AdamW step: each moves by at most lr (1e-4) plus
# the decay lr * 1e-4 * |w| either way, so two runs differ by less than
# TP_STEP_TOL for |w| < 500.
TP_GRAD_FACTOR = 4.0
TP_STEP_TOL = 2.1e-4
# (c) The ensemble of two EGNN fields against each field alone: the same
# kernels on the same inputs, one launch per member, so bit-identical is
# expected; against the plain (dense) version as phase [6]'s
# EGNN_FORWARD_TOL and, per tensor, EGNN_BACKWARD_TOL.
EGNN_MEMBERS = 2
EGNN_ENSEMBLE_T = 0.3


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def parallel_frames():
    """Phase 9's frames, PARALLEL_FRAMES of them, as (n, atoms, 3)."""
    return cartesian_frames(PARALLEL_FRAMES).reshape(-1, CART_ATOMS, 3)


def parallel_system(frames):
    from tfep_tpu_torch.io.traj import System
    return System(app_topology(), frames)


def parallel_state(device):
    """Phase 9's map, set up, its weights perturbed from the seed (the
    identity initialization zeroes the output gains): the weights every
    run of phase 15 (a) and (b)(i) starts from, on the host."""
    tfep_map = app_map(device, parallel_system(parallel_frames()),
                       HarmonicPotential(), None)
    generator = torch.Generator().manual_seed(SEED + 15)
    with torch.no_grad():
        for p in tfep_map.flow.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=generator).to(p))
    return {k: v.detach().cpu().clone()
            for k, v in tfep_map.flow.state_dict().items()}


def global_batch_order(n_frames, local_batch, n_ranks):
    """The frames in the order of the global batches of ``n_ranks`` ranks
    on contiguous shards (no shuffle): step k is each rank's k-th local
    batch, in rank order."""
    shards = np.arange(n_frames).reshape(n_ranks, -1, local_batch)
    return shards.transpose(1, 0, 2).reshape(-1)


def nccl_rank_phase(device, smi, state):
    """Phase 15 (a): Trainer(sharding=...) on one rank over NCCL at phase
    9's configuration, against the unsharded fit; the step times and the
    all-reduce's device time."""
    import tempfile

    import torch.distributed as dist

    from tfep_tpu_torch.app import Trainer
    from tfep_tpu_torch.ops.spline import LAUNCHES
    from tfep_tpu_torch.parallel.distributed import backend_for
    from tfep_tpu_torch.parallel.sharding import batch_sharding, make_mesh

    mesh = make_mesh(device=device)
    if (dist.get_backend() != backend_for(device)
            or dist.get_world_size() != 1):
        raise AssertionError('(a) not one rank over NCCL')
    system = parallel_system(parallel_frames())

    def fit(sharded, n_steps, **kwargs):
        tfep_map = app_map(device, system, HarmonicPotential(), None, state)
        trainer = Trainer(save_dir=None, max_steps=n_steps, shuffle=False,
                          sharding=batch_sharding(mesh) if sharded else None,
                          **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(tfep_map)
        torch.cuda.synchronize()
        return tfep_map, trainer, time.perf_counter() - t0

    LAUNCHES.reset()
    sharded, sharded_trainer, _ = fit(True, PARALLEL_STEPS)
    launches = (LAUNCHES.forward, LAUNCHES.backward)
    n_params = sum(p.numel() for p in sharded.flow.parameters())
    plain, plain_trainer, _ = fit(False, PARALLEL_STEPS)
    loss_diff = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(
        sharded_trainer.loss_history, plain_trainer.loss_history))
    weights, same = weights_diff(list(sharded.flow.parameters()),
                                 list(plain.flow.parameters()))
    same &= sharded_trainer.loss_history == plain_trainer.loss_history
    say(f'  (a) one rank over NCCL (make_mesh(): world 1, mesh '
        f'{tuple(mesh.shape)}), phase [9]\'s CartesianMAFMap ({n_params} '
        f'parameters, batch {B}, no logger), {PARALLEL_STEPS} steps of '
        f'Trainer(sharding=batch_sharding(mesh)) against the unsharded fit '
        f'from the same weights: losses {sharded_trainer.loss_history}; '
        f'max loss difference {loss_diff:.3e} of scale, weights max|diff| '
        f'{weights:.3e} (tolerance {PARALLEL_NCCL_TOL:g}); bit-identical: '
        f'{same}; K1/K2 launches {launches}')
    if not (loss_diff <= PARALLEL_NCCL_TOL and weights <= PARALLEL_NCCL_TOL):
        raise AssertionError('(a) the sharded fit differs from the '
                             'unsharded one')
    if launches != (N_LAYERS * PARALLEL_STEPS, N_LAYERS * PARALLEL_STEPS):
        raise AssertionError(f'(a) K1/K2 launched {launches}')
    calls = sharded_trainer.host_seconds['allreduce']
    if calls[1] != PARALLEL_STEPS:
        raise AssertionError(f'(a) {calls[1]} all-reduces in '
                             f'{PARALLEL_STEPS} steps')
    del sharded, plain

    # Step times: the difference of two fits of different length.
    times = {}
    for sharded_run in (False, True):
        short = fit(sharded_run, PARALLEL_STEPS)[2]
        long = fit(sharded_run, PARALLEL_STEPS + PARALLEL_TIMED_STEPS)[2]
        times[sharded_run] = 1e3 * (long - short) / PARALLEL_TIMED_STEPS
    # The all-reduce's device time, from the profiler.
    with tempfile.TemporaryDirectory() as work:
        _, profiled, _ = fit(True, 5, profile_dir=work, profile_steps=(2, 5))
    from torch.autograd import DeviceType
    nccl = [e for e in profiled.profile.events()
            if e.device_type == DeviceType.CUDA
            and 'nccl' in e.name.lower()]
    reduce_ms = sum(e.time_range.elapsed_us() for e in nccl) / 3 / 1e3
    host_ms = 1e3 * profiled.host_seconds['allreduce'][0] / \
        profiled.host_seconds['allreduce'][1]
    grad_bytes = 4 * (n_params + 1)
    # The collective alone on a buffer of the same size, CUDA events.
    flat = torch.zeros(n_params + 1, device=device)
    call_ms, call_host_ms = event_ms(lambda: dist.all_reduce(flat), 20, [()])
    dist.destroy_process_group()
    say(f'  (a) step: unsharded {times[False]:.3f} ms, sharded '
        f'{times[True]:.3f} ms (two fits of {PARALLEL_STEPS} and '
        f'{PARALLEL_STEPS + PARALLEL_TIMED_STEPS} steps); the all-reduce of '
        f'{grad_bytes} bytes (gradients and the loss): {reduce_ms:.3f} ms '
        f'of device time per step in {len(nccl) / 3:g} NCCL kernels '
        f'(profiler: {sorted({e.name for e in nccl})}), '
        f'{host_ms:.3f} ms of host time per call in the step; '
        f'dist.all_reduce alone on {grad_bytes} bytes: {call_ms:.4f} ms '
        f'(CUDA events over 20 calls; host {call_host_ms:.4f} ms); [{smi}]')
    return dict(launches=launches, bit_identical=same, loss_diff=loss_diff,
                weights_diff=weights, step_ms=times[False],
                sharded_step_ms=times[True], allreduce_device_ms=reduce_ms,
                allreduce_kernels=len(nccl) / 3, allreduce_call_ms=call_ms,
                allreduce_host_ms=host_ms, allreduce_bytes=grad_bytes)


def parallel_rank(port, rank, work, device='cuda'):
    """One of the two ranks of phase 15 (b), on the one card over gloo
    (NCCL refuses two ranks on one device): (i) data parallelism at phase
    9's configuration, (ii) phase 3's MAF split over tp = 2, (iii)
    shard_ensemble of 4 members. Writes ``work/rank-<rank>.pt``."""
    import torch.distributed as dist

    from tfep_tpu_torch.app import Trainer
    from tfep_tpu_torch.app.trainer import default_optimizer
    from tfep_tpu_torch.nn.conditioners.made import MADE
    from tfep_tpu_torch.nn.ensemble import (
        ensemble_init, make_ensemble_train_step, stack_modules,
    )
    from tfep_tpu_torch.ops.spline import LAUNCHES
    from tfep_tpu_torch.parallel import distributed as D
    from tfep_tpu_torch.parallel import sharding as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    D.initialize(backend='gloo', init_method=f'tcp://127.0.0.1:{port}',
                 world_size=PARALLEL_RANKS, rank=rank,
                 timeout=PARALLEL_TIMEOUT_S)
    mesh = S.make_mesh(device=device)
    result = {}

    # (i) Data parallelism: each rank its half of the frames.
    grads = []
    state = torch.load(f'{work}/state.pt', weights_only=False)
    tfep_map = app_map(device, parallel_system(parallel_frames()),
                       HarmonicPotential(), None, state,
                       batch=B // PARALLEL_RANKS)
    trainer = Trainer(save_dir=None, max_steps=PARALLEL_STEPS, shuffle=False,
                      optimizer=recording(grads),
                      sharding=S.batch_sharding(mesh))
    LAUNCHES.reset()
    trainer.fit(tfep_map)
    result['dp'] = dict(
        losses=trainer.loss_history,
        launches=(LAUNCHES.forward, LAUNCHES.backward),
        weights=[p.detach().cpu() for p in tfep_map.flow.parameters()],
        grads=[g.cpu() for g in grads[0]],
        allreduce=trainer.host_seconds['allreduce'])
    del tfep_map, trainer, grads

    # (ii) Tensor parallelism over tp = 2 (a (1, 2) mesh).
    tp_mesh = S.make_mesh(model_axis_size=PARALLEL_RANKS, device=device)
    flow, frames = build_slice(device)
    reference = copy.deepcopy(flow)
    S.shard_module(flow, tp_mesh)
    shapes = [(getattr(layer, 'kind', 'plain'), tuple(layer.weight.shape))
              for m in flow.modules() if isinstance(m, MADE)
              for layer in m.layers]
    LAUNCHES.reset()
    y, ldj = flow(frames)
    loss = ensemble_loss(flow, frames)
    flow_grads = torch.autograd.grad(loss, list(flow.parameters()))
    launches = (LAUNCHES.forward, LAUNCHES.backward)
    y_ref, ldj_ref = reference(frames)
    ref_grads = dict(zip(
        [n for n, _ in reference.named_parameters()],
        torch.autograd.grad(ensemble_loss(reference, frames),
                            list(reference.parameters()))))
    exact = copy.deepcopy(reference).double()
    set_fused(exact, 'never')
    exact_grads = dict(zip(
        [n for n, _ in exact.named_parameters()],
        torch.autograd.grad(ensemble_loss(exact, frames.double()),
                            list(exact.parameters()))))
    del exact
    shards = S.sharded_parameters(flow)
    grad_err = dict(split=0.0, replicated=0.0, ratio=0.0, passed=True,
                    worst='')
    for (name, _), g in zip(flow.named_parameters(), flow_grads):
        dim, group = shards.get(name, (None, None))

        def mine(t):
            return t if dim is None else S.local_slice(
                t, dim, dist.get_rank(group), dist.get_world_size(group))

        truth = mine(exact_grads[name])
        norm = float(truth.norm())
        split = float((g.double() - truth).norm())
        replicated = float((mine(ref_grads[name]).double() - truth).norm())
        grad_err['split'] = max(grad_err['split'], split / norm)
        grad_err['replicated'] = max(grad_err['replicated'],
                                     replicated / norm)
        ratio = split / max(replicated, 1e-30)
        if ratio > grad_err['ratio']:
            grad_err.update(ratio=ratio, worst=name)
        grad_err['passed'] &= (split <= TP_GRAD_FACTOR * replicated
                               + ENSEMBLE_GRAD_TOL * norm)
    # One AdamW step on each, from the gradients above.
    for module, gs in ((flow, flow_grads),
                       (reference, [ref_grads[n] for n, _ in
                                    reference.named_parameters()])):
        optimizer = default_optimizer(list(module.parameters()))
        for p, g in zip(module.parameters(), gs):
            p.grad = g
        optimizer.step()
    whole = S.full_state_dict(flow)
    step_diff = max(float((whole[k] - v).abs().max())
                    for k, v in reference.state_dict().items()
                    if v.is_floating_point())
    result['tp'] = dict(
        shapes=shapes, launches=launches,
        y=rel_err(y.detach(), y_ref.detach()),
        ldj=rel_err(ldj.detach(), ldj_ref.detach()), grads=grad_err,
        step=step_diff, loss=float(loss))
    del flow, reference, whole, flow_grads, ref_grads

    # (iii) shard_ensemble: ENSEMBLE_CHECKED members over the two ranks.
    members = [build_slice(device, seed=SEED + 1 + i,
                           batch=ENSEMBLE_BATCH)[0]
               for i in range(ENSEMBLE_CHECKED)]
    ens_frames = torch.randn(ENSEMBLE_BATCH, F, generator=torch.Generator(
        ).manual_seed(SEED + 100)).to(device)
    stacked = S.shard_ensemble(stack_modules(members), mesh,
                               n_members=ENSEMBLE_CHECKED)
    step = make_ensemble_train_step(ensemble_loss, ensemble_init(
        default_optimizer, stacked))
    LAUNCHES.reset()
    losses = [step(stacked, ens_frames).cpu()
              for _ in range(ENSEMBLE_COUNTED_STEPS)]
    result['ensemble'] = dict(
        losses=torch.stack(losses), launches=(LAUNCHES.forward,
                                              LAUNCHES.backward),
        weights={k: v.detach().cpu() for k, v in stacked.named_parameters()})
    torch.save(result, f'{work}/rank-{rank}.pt')
    dist.barrier()
    dist.destroy_process_group()


def parallel_ranks_phase(device, smi, state):
    """Phase 15 (b): two ranks spawned on the one card (gloo), each
    running :func:`parallel_rank`, held against one process."""
    import os
    import shutil
    import tempfile

    from tfep_tpu_torch.app import Trainer
    from tfep_tpu_torch.app.trainer import default_optimizer
    from tfep_tpu_torch.nn.ensemble import (
        ensemble_init, make_ensemble_train_step, stack_modules,
    )

    work = tempfile.mkdtemp(prefix='tfep_parallel_')
    torch.save(state, os.path.join(work, 'state.pt'))
    port = free_port()
    logs = [os.path.join(work, f'rank-{r}.log')
            for r in range(PARALLEL_RANKS)]
    t0 = time.perf_counter()
    procs = []
    for rank, log in enumerate(logs):
        with open(log, 'w') as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), '--parallel-rank',
                 str(port), str(rank), work, device.type], stdout=out,
                stderr=subprocess.STDOUT))
    try:
        # Meanwhile, the one-process references of (i) and (iii).
        frames = parallel_frames()
        order = global_batch_order(PARALLEL_FRAMES, B // PARALLEL_RANKS,
                                   PARALLEL_RANKS)
        grads = []
        one = app_map(device, parallel_system(frames[order]),
                      HarmonicPotential(), None, state)
        trainer = Trainer(save_dir=None, max_steps=PARALLEL_STEPS,
                          shuffle=False, optimizer=recording(grads))
        trainer.fit(one)
        one_losses = trainer.loss_history
        one_weights = [p.detach().cpu() for p in one.flow.parameters()]
        one_grads = [g.cpu() for g in grads[0]]
        del one, trainer, grads
        members = [build_slice(device, seed=SEED + 1 + i,
                               batch=ENSEMBLE_BATCH)[0]
                   for i in range(ENSEMBLE_CHECKED)]
        ens_frames = torch.randn(ENSEMBLE_BATCH, F, generator=torch.Generator(
            ).manual_seed(SEED + 100)).to(device)
        stacked = stack_modules(members)
        step = make_ensemble_train_step(ensemble_loss, ensemble_init(
            default_optimizer, stacked))
        ens_losses = torch.stack([step(stacked, ens_frames).cpu()
                                  for _ in range(ENSEMBLE_COUNTED_STEPS)])
        ens_weights = {k: v.detach().cpu()
                       for k, v in stacked.named_parameters()}
        del members, stacked, step
        for proc in procs:
            proc.wait(timeout=PARALLEL_TIMEOUT_S)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for proc, log in zip(procs, logs):
        if proc.returncode != 0:
            with open(log) as f:
                say(f.read()[-6000:])
            raise AssertionError(f'(b) a rank exited with {proc.returncode}')
    results = [torch.load(os.path.join(work, f'rank-{r}.pt'),
                          weights_only=False) for r in range(PARALLEL_RANKS)]
    shutil.rmtree(work, ignore_errors=True)
    say(f'  (b) {PARALLEL_RANKS} ranks spawned on the one card, gloo '
        f'(NCCL refuses two ranks on one device); {wall:.1f} s with the '
        f'references in this process')

    # (i)
    first, second = (r['dp'] for r in results)
    loss_diff = max(abs(a - b) / max(1.0, abs(b))
                    for a, b in zip(first['losses'], one_losses))
    grad_err = grads_diff(first['grads'], one_grads)
    weights, _ = weights_diff(first['weights'], one_weights)
    rank_weights, rank_same = weights_diff(first['weights'],
                                           second['weights'])
    say(f'  (b)(i) data parallelism, {B // PARALLEL_RANKS} rows per rank, '
        f'{PARALLEL_STEPS} steps, against one process at batch {B} on the '
        f'same global batches: losses {first["losses"]} (one process '
        f'{one_losses}), {loss_diff:.3e} of scale (tolerance '
        f'{APP_LOSS_TOL:g}); first gradients, largest |diff|/|g| per tensor '
        f'{grad_err:.3e} (tolerance {ENSEMBLE_GRAD_TOL:g}); weights max|diff|'
        f' {weights:.3e} (tolerance {PARALLEL_WEIGHT_TOL:g}); the two ranks\' '
        f'losses equal: {first["losses"] == second["losses"]}, weights '
        f'bit-identical: {rank_same}; K1/K2 per rank {first["launches"]}, '
        f'{first["allreduce"][1]} all-reduces, '
        f'{1e3 * first["allreduce"][0] / first["allreduce"][1]:.3f} ms each '
        f'(host, gloo on CUDA tensors)')
    if not (loss_diff <= APP_LOSS_TOL and grad_err <= ENSEMBLE_GRAD_TOL
            and weights <= PARALLEL_WEIGHT_TOL):
        raise AssertionError('(b)(i) the data-parallel fit differs from one '
                             'process')
    if first['losses'] != second['losses'] or not rank_same:
        raise AssertionError('(b)(i) the ranks disagree')
    expected = (N_LAYERS * PARALLEL_STEPS, N_LAYERS * PARALLEL_STEPS)
    if first['launches'] != expected or second['launches'] != expected:
        raise AssertionError('(b)(i) K1/K2 launches')

    # (ii)
    for rank, result in enumerate(results):
        tp = result['tp']
        grads = tp['grads']
        say(f'  (b)(ii) rank {rank}, phase [3]\'s MAF over tp = 2: MADE '
            f'weight shapes per layer {sorted(set(tp["shapes"]))}; y '
            f'{tp["y"][1]:.3e}, log_det_J {tp["ldj"][1]:.3e} of scale '
            f'against the replicated flow (tolerance {MAP_TOL:g}); '
            f'gradients against float64, largest |diff|/|g| per tensor: '
            f'split {grads["split"]:.3e}, replicated float32 '
            f'{grads["replicated"]:.3e}; largest ratio of the two '
            f'{grads["ratio"]:.2f} ({grads["worst"]}; tolerance '
            f'{TP_GRAD_FACTOR:g} x the replicated error + '
            f'{ENSEMBLE_GRAD_TOL:g} of the norm): '
            f'{"held" if grads["passed"] else "MISSED"}; weights after one '
            f'AdamW step max|diff| {tp["step"]:.3e} (tolerance '
            f'{TP_STEP_TOL:g}); K1/K2 {tp["launches"]} in two forwards and '
            f'a backward')
        kinds = [kind for kind, _ in tp['shapes']]
        if kinds != ['column', 'column', 'row'] * N_LAYERS:
            raise AssertionError(f'(b)(ii) the layers are {kinds}')
        if not (tp['y'][1] <= MAP_TOL and tp['ldj'][1] <= MAP_TOL
                and grads['passed'] and tp['step'] <= TP_STEP_TOL):
            raise AssertionError('(b)(ii) the tensor-parallel flow differs')
        if tp['launches'] != (2 * N_LAYERS, N_LAYERS):
            raise AssertionError(f'(b)(ii) K1/K2 launched {tp["launches"]}')

    # (iii)
    per_rank = ENSEMBLE_CHECKED // PARALLEL_RANKS
    worst = dict(loss=0.0, weights=0.0)
    for rank, result in enumerate(results):
        ens = result['ensemble']
        rows = slice(rank * per_rank, (rank + 1) * per_rank)
        worst['loss'] = max(worst['loss'], float(
            ((ens['losses'] - ens_losses[:, rows]).abs()
             / ens_losses[:, rows].abs().clamp(min=1.0)).max()))
        for name, value in ens['weights'].items():
            worst['weights'] = max(worst['weights'], float(
                (value - ens_weights[name][rows]).abs().max()))
        if ens['launches'] != (N_LAYERS * ENSEMBLE_COUNTED_STEPS,) * 2:
            raise AssertionError(f'(b)(iii) K1/K2 launched {ens["launches"]}')
    weight_tol = ENSEMBLE_COUNTED_STEPS * ENGINE_WEIGHT_TOL
    say(f'  (b)(iii) shard_ensemble, {ENSEMBLE_CHECKED} members of phase '
        f'[3]\'s flow over {PARALLEL_RANKS} ranks ({per_rank} each, batch '
        f'{ENSEMBLE_BATCH}), {ENSEMBLE_COUNTED_STEPS} steps against the '
        f'unsharded ensemble: losses {worst["loss"]:.3e} of scale '
        f'(tolerance {ENSEMBLE_LOSS_TOL:g}), weights max|diff| '
        f'{worst["weights"]:.3e} (tolerance {weight_tol:g}); K1/K2 per rank '
        f'{results[0]["ensemble"]["launches"]}')
    if not (worst['loss'] <= ENSEMBLE_LOSS_TOL
            and worst['weights'] <= weight_tol):
        raise AssertionError('(b)(iii) the sharded ensemble differs')
    launches = [sum(r[key]['launches'][i] for r in results
                    for key in ('dp', 'tp', 'ensemble')) for i in (0, 1)]
    return dict(
        dp=dict(loss_diff=loss_diff, grads=grad_err, weights=weights),
        tp=[dict(shapes=sorted(set(r['tp']['shapes'])), y=r['tp']['y'][1],
                 ldj=r['tp']['ldj'][1], grads=r['tp']['grads'],
                 step=r['tp']['step']) for r in results],
        ensemble=worst, wall_s=wall, launches=tuple(launches))


def egnn_ensemble_phase(device, smi):
    """Phase 15 (c): cnf_bench's EGNN field, pairwise='fused', as a K = 2
    ensemble under ensemble_map: forward_and_jvp and its gradient against
    each field alone and against the plain (dense) version; K3/K4/K5
    counted."""
    from tfep_tpu_torch.nn.dynamics import EGNNDynamics
    from tfep_tpu_torch.nn.ensemble import (
        ensemble_init, ensemble_map, make_ensemble_train_step, stack_modules,
    )
    from tfep_tpu_torch.ops.egnn import LAUNCHES

    fields = [EGNNDynamics.create(
        torch.Generator().manual_seed(SEED + 20 + i),
        node_types=np.arange(N_ATOMS) % 4, r_cutoff=R_CUTOFF,
        time_feat_dim=16, node_feat_dim=CNF_FEAT,
        distance_feat_dim=CNF_FEAT, n_layers=CNF_LAYERS,
        initialize_identity=False, device=device, pairwise='fused')
        for i in range(EGNN_MEMBERS)]
    dense = []
    for field in fields:
        plain = copy.deepcopy(field)
        for layer in plain.graph_layers:
            layer.pairwise = 'dense'
        dense.append(plain)
    generator = torch.Generator().manual_seed(SEED + 30)
    x = (0.5 * torch.randn(CNF_BATCH, 3 * N_ATOMS, generator=generator)
         ).to(device)
    v = torch.randn(CNF_BATCH, 3 * N_ATOMS, generator=generator).to(device)
    t = EGNN_ENSEMBLE_T

    def loss(field, batch):
        f, df = field.forward_and_jvp(t, *batch)
        return torch.mean(f * f) + torch.mean(f * df)

    stacked = stack_modules(fields)
    LAUNCHES.reset()
    f, df = ensemble_map(lambda m, x, v: m.forward_and_jvp(t, x, v),
                         stacked, x, v)
    k4 = LAUNCHES.k4
    LAUNCHES.reset()
    with torch.no_grad():
        out = ensemble_map(lambda m, x: m(t, x), stacked, x)
    k3 = LAUNCHES.k3
    grads = []
    step = make_ensemble_train_step(loss, ensemble_init(recording(grads),
                                                        stacked))
    LAUNCHES.reset()
    losses = step(stacked, (x, v))
    counted = (LAUNCHES.k3, LAUNCHES.k4, LAUNCHES.k5)
    torch.cuda.synchronize()
    expected = EGNN_MEMBERS * CNF_LAYERS
    if (k3, k4) != (expected, expected) or counted != (0, expected,
                                                       expected):
        raise AssertionError(f'(c) K3/K4/K5 launched {k3}, {k4}, {counted}')
    worst = dict(alone=0.0, plain=0.0, grad_alone=0.0, grad_plain=0.0)
    same = True
    for k, (field, plain) in enumerate(zip(fields, dense)):
        with torch.no_grad():
            f_k, df_k = field.forward_and_jvp(t, x, v)
            out_k = field(t, x)
            f_p, df_p = plain.forward_and_jvp(t, x, v)
        same &= bool(torch.equal(f[k], f_k) and torch.equal(df[k], df_k)
                     and torch.equal(out[k], out_k))
        for ours, alone, theirs in ((f[k], f_k, f_p), (df[k], df_k, df_p)):
            worst['alone'] = max(worst['alone'],
                                 rel_err(ours.detach(), alone)[1])
            worst['plain'] = max(worst['plain'],
                                 rel_err(ours.detach(), theirs)[1])
        params = list(field.parameters())
        g_alone = torch.autograd.grad(loss(field, (x, v)), params,
                                      allow_unused=True)
        g_plain = torch.autograd.grad(loss(plain, (x, v)),
                                      list(plain.parameters()),
                                      allow_unused=True)
        ours = [g[k] for g in grads[0]]
        fill = [torch.zeros_like(p) for p in params]
        worst['grad_alone'] = max(worst['grad_alone'], grads_diff(
            ours, [g if g is not None else z
                   for g, z in zip(g_alone, fill)]))
        worst['grad_plain'] = max(worst['grad_plain'], grads_diff(
            ours, [g if g is not None else z
                   for g, z in zip(g_plain, fill)]))
    say(f'  (c) {EGNN_MEMBERS} fields of cnf_bench\'s EGNN ({N_ATOMS} atoms, '
        f'{CNF_LAYERS} layers of width {CNF_FEAT}, batch {CNF_BATCH}, '
        f'pairwise=\'fused\') stacked, under ensemble_map: K4 {k4} per '
        f'forward_and_jvp, K3 {k3} per no-grad field, K3/K4/K5 {counted} per '
        f'make_ensemble_train_step (one launch per member and layer); '
        f'against each field alone: values and tangents {worst["alone"]:.3e}'
        f' of scale, bit-identical {same}, gradients {worst["grad_alone"]:.3e}'
        f' per tensor (tolerances {EGNN_FORWARD_TOL:g}, {EGNN_BACKWARD_TOL:g});'
        f' against the plain (dense) version: {worst["plain"]:.3e}, '
        f'gradients {worst["grad_plain"]:.3e}; losses '
        f'{[round(float(l), 6) for l in losses]}; [{smi}]')
    if not (worst['alone'] <= EGNN_FORWARD_TOL
            and worst['plain'] <= EGNN_FORWARD_TOL
            and worst['grad_alone'] <= EGNN_BACKWARD_TOL
            and worst['grad_plain'] <= EGNN_BACKWARD_TOL
            and torch.isfinite(losses).all()):
        raise AssertionError('(c) the EGNN ensemble differs')
    return dict(checks=worst, bit_identical=same,
                launches={'k3': k3 + counted[0], 'k4': k4 + counted[1],
                          'k5': counted[2]})


def parallel_phase(device, smi):
    """Phase 15: (a), (b) and (c); returns their results and time."""
    t0 = time.perf_counter()
    state = parallel_state(device)
    nccl = nccl_rank_phase(device, smi, state)
    torch.cuda.empty_cache()
    ranks = parallel_ranks_phase(device, smi, state)
    torch.cuda.empty_cache()
    egnn = egnn_ensemble_phase(device, smi)
    seconds = time.perf_counter() - t0
    say(f'  phase [15] took {seconds:.1f} s')
    launches = (nccl['launches'][0] + ranks['launches'][0],
                nccl['launches'][1] + ranks['launches'][1])
    return dict(nccl=nccl, ranks=ranks, egnn=egnn, seconds=seconds,
                launches=launches)


# Phase 16: the examples, each at its JAX example's size.
EXAMPLES = ('toy_gaussian_tfep', 'multimap_tfep_triatomic',
            'solvated_preflow_tfep', 'multimap_tfep_mixed', 'ensemble_tfep',
            'engine_in_the_loop_tfep', 'cnf_tfep')
# The examples whose maps have spline transformers, so run K1/K2 (the
# others are affine MAFs or the CNF).
SPLINE_EXAMPLES = ('solvated_preflow_tfep', 'multimap_tfep_mixed')
# K1/K2 in float64 at the solvated example's shape.
F64_B, F64_F, F64_BOUND = 512, 36, 8.0
# Kernel against plain version in float64, relative to max(1, scale):
# the tolerances the port's tests hold values and gradients to. float64
# exp, log and division are correctly rounded or within an ulp, so the
# fifty-odd dependent operations leave errors near 1e-14.
F64_FORWARD_TOL = 1e-10
F64_BACKWARD_TOL = 1e-9
DISTRIBUTED_TIMEOUT_S = 600
# The example that runs in a process of its own, beside the others.
BESIDE = 'cnf_tfep'
EXAMPLE_TIMEOUT_S = 1000


def f64_spline_inputs(device, seed):
    """Inputs at the solvated example's shape, float64: x on [-8, 8]
    (5% of it beyond the bounds, in the linear tails), kept 1e-6 away
    from every knot; parameters as a spline MAF's conditioner gives them
    early in training."""
    g = torch.Generator().manual_seed(seed)
    dt = torch.float64
    bound = F64_BOUND * torch.ones(F64_F, dtype=dt)
    x = -F64_BOUND + 2 * F64_BOUND * torch.rand(F64_B, F64_F, generator=g,
                                                dtype=dt)
    outside = torch.rand(F64_B, F64_F, generator=g) < 0.05
    x = torch.where(outside, x.sign() * (F64_BOUND + x.abs() / 4), x)
    params = 0.5 * torch.randn(F64_B, (3 * K + 1) * F64_F, generator=g,
                               dtype=dt)
    width = 2 * F64_BOUND
    knots = -bound + torch.cumsum(torch.softmax(
        params.reshape(F64_B, 3 * K + 1, F64_F)[:, :K], dim=1)
        * (width - K * 1e-4) + 1e-4, dim=1)
    knots = torch.cat([-bound.expand(F64_B, 1, F64_F), knots], dim=1)
    near = (x[:, None] - knots).abs().min(dim=1).values < 1e-6
    x = torch.where(near, x + 3e-6, x)
    cast = dict(dtype=dt, device=device)
    return (x.to(**cast), params.to(**cast), (-bound).to(**cast),
            bound.to(**cast), (-bound).to(**cast), bound.to(**cast))


def f64_kernel_phase(device):
    """K1 and K2 in float64 against the plain version at the solvated
    example's shape; returns the errors."""
    from tfep_tpu_torch.ops import spline as fs
    x, params, *bounds = f64_spline_inputs(device, 4)
    g = torch.Generator().manual_seed(5)
    gy, gl = (torch.randn(F64_B, F64_F, generator=g, dtype=torch.float64)
              .to(device) for _ in range(2))
    outs = {}
    for name, fn in (('kernel', fs.fused_spline),
                     ('plain', fs.fused_spline_reference)):
        xi = x.clone().requires_grad_()
        pi = params.clone().requires_grad_()
        y, dl = fn(xi, pi, *bounds, K)
        gx, gp = torch.autograd.grad((y, dl), (xi, pi), (gy, gl))
        outs[name] = [t.detach() for t in (y, dl, gx, gp)]
    torch.cuda.synchronize()
    errors = {}
    for i, label in enumerate(('y', 'dl', 'grad_x', 'grad_params')):
        kern, plain = outs['kernel'][i], outs['plain'][i]
        if kern.dtype != torch.float64 or not torch.isfinite(kern).all():
            raise AssertionError(f'float64 {label}: not finite float64')
        err, rel = rel_err(kern, plain)
        tol = F64_FORWARD_TOL if i < 2 else F64_BACKWARD_TOL
        say(f'  float64 {label:11s} max|kernel-plain| = {err:.3e} '
            f'(relative to scale {rel:.3e}, tolerance {tol:g})')
        if not rel <= tol:
            raise AssertionError(f'float64 {label} disagrees')
        key = 'forward' if i < 2 else 'backward'
        errors[key] = max(errors.get(key, 0.0), err)
    return errors


def _example_line(name, results, seconds, launches):
    if results.get('dfs') is not None:
        estimate = (f'df per member {np.round(results["dfs"], 4).tolist()}'
                    f' (spread {results["spread"]:.4f})')
    else:
        low, high = results['ci']
        estimate = (f'df {results["df"]:.4f} kT, CI [{low:.4f}, '
                    f'{high:.4f}]')
    return (f'  {name}: {estimate}, analytic {results["df_analytic"]:.4f} '
            f'kT, margin {results["margin"]:g}; {results["steps"]} steps; '
            f'training {results["wall_s"]:.1f} s, run and check '
            f'{seconds:.1f} s; K1/K2 launches {launches[0]}/{launches[1]}')


def distributed_example(smi):
    """The port's distributed example as a subprocess: 2 gloo ranks on the
    one card. Returns its figures, read from its output."""
    import os
    import re
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
    env.pop('DIST_TFEP_DEVICE', None)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, '-m', 'tfep_tpu_torch.examples.distributed_tfep'],
        cwd=root, env=env, capture_output=True, text=True,
        timeout=DISTRIBUTED_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if out.returncode != 0 or 'DISTRIBUTED TFEP OK' not in out.stdout:
        raise AssertionError('distributed_tfep failed:\n'
                             + out.stdout[-3000:] + out.stderr[-3000:])
    number = r'(-?[0-9.]+)'
    df = re.search(r'multimap TFEP df = ' + number + r' kT   CI=\['
                   + number + ', ' + number + r'\]', out.stdout)
    analytic = re.search(r'analytic df\s+= ' + number, out.stdout)
    steps = re.search(r'steps: (\d+) \(walls: \[([^\]]*)\]s\)',
                      out.stdout)
    results = dict(df=float(df.group(1)),
                   ci=(float(df.group(2)), float(df.group(3))),
                   df_analytic=float(analytic.group(1)), margin=0.15,
                   steps=int(steps.group(1)),
                   wall_s=max(float(w) for w in steps.group(2).split(',')))
    say(_example_line('distributed_tfep (2 ranks)', results, seconds, (0, 0))
        + f' [{smi}]')
    return dict(results, seconds=seconds)


def run_example(name, device, workdir=None):
    """One example's ``run`` and ``check(statistical=True)``, with its
    K1/K2 launches (the counts set to 0 just before); returns its
    figures."""
    import importlib
    from tfep_tpu_torch.ops import spline as fs
    module = importlib.import_module(f'tfep_tpu_torch.examples.{name}')
    fs.LAUNCHES.reset()
    start = time.perf_counter()
    results = module.run(device, workdir)
    module.check(results, statistical=True)
    seconds = time.perf_counter() - start
    launches = [fs.LAUNCHES.forward, fs.LAUNCHES.backward]
    row = dict(df=results.get('df'), ci=results.get('ci'),
               df_analytic=float(results['df_analytic']),
               margin=results['margin'], steps=results['steps'],
               wall_s=results['wall_s'], seconds=seconds, launches=launches)
    for key in ('dfs', 'spread', 'com_drift', 'var_mapped', 'var_identity',
                'eval_s'):
        if key in results:
            row[key] = np.asarray(results[key]).tolist()
    return row


def example_process(name, workdir):
    """``--example NAME WORKDIR``: :func:`run_example` on the card in a
    process of its own; its figures go to ``WORKDIR/NAME.json``."""
    import os
    row = run_example(name, torch.device('cuda'), workdir)
    with open(os.path.join(workdir, f'{name}.json'), 'w') as f:
        json.dump(row, f)


def _check_launches(name, launches):
    if name in SPLINE_EXAMPLES:
        if not (launches[0] > 0 and launches[1] > 0):
            raise AssertionError(f'{name}: K1/K2 never launched')
    elif tuple(launches) != (0, 0):
        raise AssertionError(f'{name}: K1/K2 launched {launches}')


def examples_phase(device, smi):
    """Phase 16: K1/K2 in float64, then every example on the card. The
    CNF example (host-bound, the longest) runs in a process of its own
    beside the others."""
    import os
    import tempfile
    t0 = time.perf_counter()
    errors = f64_kernel_phase(device)
    summary = {}
    total = [0, 0]
    workdir = tempfile.mkdtemp(prefix='chip_smoke_examples_')
    log_path = os.path.join(workdir, f'{BESIDE}.log')
    with open(log_path, 'w') as log:
        beside = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--example', BESIDE,
             workdir], stdout=log, stderr=subprocess.STDOUT)
    try:
        for name in EXAMPLES:
            if name == BESIDE:
                continue
            row = run_example(name, device)
            say(_example_line(name, row, row['seconds'], row['launches'])
                + f' [{smi}]')
            _check_launches(name, row['launches'])
            total = [total[0] + row['launches'][0],
                     total[1] + row['launches'][1]]
            summary[name] = row
            torch.cuda.empty_cache()
        summary['distributed_tfep'] = distributed_example(smi)
        beside.wait(timeout=EXAMPLE_TIMEOUT_S)
    finally:
        if beside.poll() is None:
            beside.kill()
            beside.wait()
    if beside.returncode != 0:
        with open(log_path) as f:
            raise AssertionError(f'{BESIDE} failed:\n{f.read()[-4000:]}')
    with open(os.path.join(workdir, f'{BESIDE}.json')) as f:
        row = json.load(f)
    say(_example_line(BESIDE + ' (own process)', row, row['seconds'],
                      row['launches']) + f' [{smi}]')
    _check_launches(BESIDE, row['launches'])
    summary[BESIDE] = row
    seconds = time.perf_counter() - t0
    say(f'  phase [16] took {seconds:.1f} s')
    return dict(examples=summary, errors=errors, launches=tuple(total),
                seconds=seconds)


def main():
    import threading

    started = time.perf_counter()

    def stage(*args):
        say(*args)
        say(f'  (at {time.perf_counter() - started:.1f} s of the script)')

    import tfep_tpu_torch  # noqa: F401  (fails outside a checkout)
    from tfep_tpu_torch.ops import egnn

    stage('[1] card')
    smi = card_phase()
    device = torch.device('cuda')
    # nvcc builds the EGNN kernels while the Triton phases run.
    built = []
    build_thread = threading.Thread(target=lambda: built.append(_timed_build(
        egnn.build)))
    build_thread.start()

    stage('[2] kernels against their plain version (float32, bench shape)')
    t0 = time.perf_counter()
    errors = kernel_phase(device)
    say(f'  built and checked in {time.perf_counter() - t0:.1f} s')
    kernel_resources(device)

    stage('[3] the slice: spline-MAF training step at the bench config')
    flow, frames = build_slice(device)
    launches, train_step = slice_phase(flow, frames, N_STEPS)

    stage('[4] times')
    rows, step = timing_phase(device, flow, frames, train_step, smi)
    # Phase 14 sets its bf16 step beside this float32 one.
    maf_handoff = dict(step_ms=step['step_ms'], kinds={})
    maf_handoff['busy_ms'] = profile_phase(train_step, step['step_ms'], smi,
                                           kinds_out=maf_handoff['kinds'])
    del flow, frames, train_step
    torch.cuda.empty_cache()

    stage('[5] EGNN kernels K3/K4/K5 against their plain version (float32)')
    build_thread.join()
    if not built or isinstance(built[0], BaseException):
        raise RuntimeError('building the EGNN kernels failed') from (
            built[0] if built else None)
    path, build_s = built[0]
    say(f'  nvcc built {path.name} in {build_s:.1f} s (beside the Triton '
        'phases); ptxas:')
    for line in path.with_suffix('.ptxas.txt').read_text().splitlines():
        if 'registers' in line or 'spill' in line:
            say('   ', line.strip())
    egnn_errors = egnn_kernel_phase(device)

    stage('[6] the CNF slice: cnf_bench training step, pairwise=fused')
    cnf, cnf_frames = build_cnf(device)
    cnf_launches, cnf_step = cnf_phase(cnf, cnf_frames)
    # Phase 11 holds the CNF map against these weights and frames.
    cnf_handoff = dict(state={k: v.detach().cpu().clone()
                              for k, v in cnf.state_dict().items()},
                       frames=cnf_frames.cpu())

    stage('[7] CNF times')
    egnn_rows = egnn_timing_phase(device, smi)
    cnf_times = cnf_timing_phase(cnf, cnf_frames, cnf_step, smi)
    cnf_handoff.update(step_ms=cnf_times['step_ms'], busy_ms=profile_phase(
        cnf_step, cnf_times['step_ms'], smi, n=2, batch=CNF_BATCH))
    del cnf, cnf_frames, cnf_step
    torch.cuda.empty_cache()

    stage('[8] the Cartesian reference-frame slice: the MAF inside the '
          'CartesianMAFMap stack, K1/K2 at F=90')
    handoff = {}
    cart = cartesian_phase(device, smi, handoff)
    handoff.update(step_ms=cart['step_ms'])
    torch.cuda.empty_cache()

    stage('[9] the entry point: the port\'s CartesianMAFMap on phase 8\'s '
          'configuration, trained through Trainer.fit')
    app = app_phase(device, smi, handoff)
    # Phase 13 trains the same map from the same weights against an engine.
    engine_handoff = dict(
        state={k: v.cpu() for k, v in handoff['state'].items()},
        first_loss=app['first_loss'],
        step_ms_without_logger=app['step_ms_without_logger'])
    del handoff
    torch.cuda.empty_cache()

    stage('[10] the flagship map: the port\'s MixedMAFMap at '
          'bench_mixed_jax\'s configuration, trained through Trainer.fit; '
          'K1/K2 at F=30')
    mixed = mixed_phase(device, smi)
    torch.cuda.empty_cache()

    stage('[11] the CNF map: the port\'s ContinuousEGNNMap at cnf_bench\'s '
          'configuration, trained through Trainer.fit')
    cnf_map = cnf_map_phase(device, smi, cnf_handoff)
    torch.cuda.empty_cache()

    stage('[12] from a trajectory file to Δf: phase [10]\'s configuration '
          'written as XTC + PDB, trained lazily from the file, estimated on '
          'the card')
    file_map = file_phase(device, smi, mixed)
    torch.cuda.empty_cache()

    stage('[13] the potentials bridge: phase [9]\'s map trained against a '
          'host engine through the autograd bridge, plainly and with '
          'engine_overlap=True')
    engine = engine_phase(device, smi, engine_handoff)
    torch.cuda.empty_cache()

    stage('[14] ensembles and bf16 products: ensemble_bench\'s configuration '
          'trained as K vmapped members, K1/K2 on the folded rows; phase '
          '[3]\'s MAF with compute_dtype=\'bfloat16\'')
    ensemble = ensemble_phase(device, smi)
    bf16 = bf16_phase(device, smi, maf_handoff)
    torch.cuda.empty_cache()

    stage('[15] multi-process training: Trainer(sharding=...) on one rank '
          'over NCCL; two ranks on the one card over gloo (data, tensor and '
          'ensemble parallelism); the fused EGNN field as a vmapped ensemble')
    parallel = parallel_phase(device, smi)
    torch.cuda.empty_cache()

    stage('[16] the examples in float64: K1/K2 at the solvated example\'s '
          'shape, then each example at its JAX original\'s size against its '
          'analytic df')
    examples = examples_phase(device, smi)

    tpu = 'tfep_tpu/ops/pallas/spline.py'
    replaces = {'spline_forward': f'{tpu}:82 (_forward_kernel, launched '
                                  f'at {tpu}:304 from _fused_spline_fwd_impl '
                                  f'{tpu}:382)',
                'spline_backward': f'{tpu}:143 (_backward_kernel, launched '
                                   f'at {tpu}:304 from _fused_spline_bwd '
                                   f'{tpu}:407)'}
    kernels = []
    for row, which, i in zip(rows, ('forward', 'backward'), (0, 1)):
        kernels.append({
            'name': row['name'], 'route': 'triton',
            'source': 'tfep_tpu_torch/ops/spline.py',
            'replaces': replaces[row['name']],
            'launches': launches[which],
            'launches_by_path': {
                'maf_slice': launches[which],
                'cartesian_slice': cart['launches'][which],
                'cartesian_map': app['launches'][i],
                'mixed_map': mixed['launches'][i],
                'file_map': file_map['launches'][i],
                'engine_map': engine['launches'][i],
                'engine_map_pipelined': engine['pipelined_launches'][i],
                'ensemble': ensemble['launches'][i],
                'maf_bf16': bf16['launches'][i],
                'parallel_nccl': parallel['nccl']['launches'][i],
                'parallel_two_ranks': parallel['ranks']['launches'][i],
                'examples': examples['launches'][i]},
            'max_abs_err': max(errors[which], cart['errors'][which],
                               mixed['errors'][which],
                               ensemble['errors'][which],
                               examples['errors'][which]),
            'ms': row['ms'], 'plain_ms': row['plain_ms'],
            'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
            'library_ms': None})
    egnn_tpu = 'tfep_tpu/ops/pallas/egnn.py'
    egnn_replaces = {
        'egnn_forward': (f'{egnn_tpu}:113 (_forward_kernel, launched at '
                         f'{egnn_tpu}:495 from _fwd_impl {egnn_tpu}:484)',
                         'k3', 'K3'),
        'egnn_jvp': (f'{egnn_tpu}:193 (_jvp_kernel, launched at '
                     f'{egnn_tpu}:286 from _jvp_op {egnn_tpu}:265)',
                     'k4', 'K4'),
        'egnn_jvp_backward': (f'{egnn_tpu}:208 (_jvp_bwd_kernel, launched '
                              f'at {egnn_tpu}:338 from _jvp_op_bwd '
                              f'{egnn_tpu}:305)', 'k5', 'K5')}
    for row in egnn_rows:
        where, count, label = egnn_replaces[row['name']]
        kernels.append({
            'name': row['name'], 'route': 'cuda',
            'source': 'tfep_tpu_torch/csrc/egnn.cu',
            'replaces': where, 'launches': cnf_launches[count],
            'launches_by_path': {
                'cnf_slice': cnf_launches[count],
                'cnf_map': cnf_map['launches'][count],
                'egnn_ensemble': parallel['egnn']['launches'][count]},
            'max_abs_err': egnn_errors[label],
            'ms': row['ms'], 'plain_ms': row['plain_ms'],
            'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
            'library_ms': None})
    say(json.dumps({'eager_launch_ms': {r['name']: r['eager_ms']
                                        for r in rows},
                    'train_step_ms': step['step_ms'],
                    'train_frames_per_s': step['frames_per_s'],
                    'eval_ms': step['eval_ms'],
                    'peak_memory_bytes': step['peak_bytes'],
                    'cnf': cnf_times,
                    'cartesian': {k: v for k, v in cart.items()
                                  if k != 'errors'},
                    'app': app,
                    'mixed': {k: v for k, v in mixed.items()
                              if k != 'errors'},
                    'cnf_map': cnf_map,
                    'file_map': {k: v for k, v in file_map.items()
                                 if k not in ('files', 'analysis')},
                    'files': file_map['files'],
                    'analysis': file_map['analysis'],
                    'engine': engine,
                    'ensemble': {k: v for k, v in ensemble.items()
                                 if k != 'errors'},
                    'maf_bf16': bf16,
                    'parallel': parallel,
                    'examples': examples,
                    'card': smi}))
    say(f'whole script: {time.perf_counter() - started:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if sys.argv[1:2] == ['--parallel-rank']:
        parallel_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                      sys.argv[5])
    elif sys.argv[1:2] == ['--example']:
        example_process(sys.argv[2], sys.argv[3])
    else:
        main()
