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
4. Times on the card: each kernel and its plain version, the training
   step, the map evaluation, peak memory, and a ``torch.profiler``
   breakdown of the training step by kind of kernel, with its table.
5. EGNN kernels: ``nvcc`` builds the CUDA kernels K3 (forward), K4
   (forward and tangent) and K5 (backward of K4) from this checkout while
   phases 2-4 run; each is held against its plain PyTorch version in
   float32 at the bench shape of ``benchmarks/cnf_bench.py`` (B=256, n=32,
   F=D=64) and at a ragged shape with pairs beyond the cutoff.
6. CNF slice: ``benchmarks/cnf_bench.py``'s configuration with
   ``pairwise='fused'`` (32 atoms, EGNN dynamics of 4 layers at width 64,
   rk4 with 8 steps, one Hutchinson probe, regularization, checkpointed
   steps, batch 256, AdamW), random weights from a seed. The map and the
   loss gradients against the float64 dense path on the same weights and
   probe; then the counted path (counts of K3/K4/K5 set to 0 just before,
   read just after): one no-grad map evaluation, the training steps, one
   plain evaluation of the field; then a forward/inverse round trip.
7. CNF times: each EGNN kernel and its plain version, the training step
   (beside the dense path's on the same map), the map evaluation, peak
   memory, and the profiler's breakdown of the step.

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


def spline_inputs(adversarial, device, seed):
    """Bench-shape inputs on the domain [-3, 3]; x kept 1e-4 away from
    every knot, where the bin, and so the gradient, is discontinuous."""
    g = torch.Generator().manual_seed(seed)
    bound = torch.ones(F, dtype=torch.float64)
    x0, xf = -3.0 * bound, 3.0 * bound
    if adversarial:
        x = -2.95 + 0.75 * torch.rand(B, F, generator=g, dtype=torch.float64)
        params = torch.zeros(B, (3 * K + 1) * F, dtype=torch.float64)
        params[:, 2 * K * F:] = 9.0
        params[:, (K + 3) * F:(K + 4) * F] = -30.0
        params += 0.1 * torch.randn(params.shape, generator=g,
                                    dtype=torch.float64)
    else:
        # Half the batch inside [-3, 3), half outside (3 <= |x| < 6).
        u = torch.rand(B, F, generator=g, dtype=torch.float64)
        sign = torch.where(torch.rand(B, F, generator=g) < 0.5, -1.0, 1.0)
        x = torch.cat([-3.0 + 6.0 * u[:B // 2],
                       sign[B // 2:] * (3.0 + 3.0 * u[B // 2:])])
        params = 0.5 * torch.randn(B, (3 * K + 1) * F, generator=g,
                                   dtype=torch.float64)
    knots = x0 + torch.cumsum(torch.softmax(
        params.reshape(B, 3 * K + 1, F)[:, :K], dim=1) * (6.0 - K * 1e-4)
        + 1e-4, dim=1)
    knots = torch.cat([x0.expand(B, 1, F), knots], dim=1)
    near = (x[:, None] - knots).abs().min(dim=1).values < 1e-4
    x = torch.where(near, x + 3e-4, x)
    cast = dict(dtype=torch.float32, device=device)
    return (x.to(**cast), params.to(**cast), x0.to(**cast), xf.to(**cast),
            x0.to(**cast), xf.to(**cast))


def kernel_phase(device):
    """K1 and K2 against the plain version; returns the measured errors."""
    from tfep_tpu_torch.ops import spline as fs
    results = {}
    for case in ('mixed', 'adversarial'):
        x, params, *bounds = spline_inputs(case == 'adversarial', device, 1)
        g = torch.Generator().manual_seed(2)
        gy = torch.randn(B, F, generator=g).to(device)
        gl = torch.randn(B, F, generator=g).to(device)
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
    grid = fs._grid(B, F)
    kernels = fs._kernels()
    blocks = dict(K=K, BLOCK_B=fs.BLOCK_B, BLOCK_F=fs.BLOCK_F,
                  num_warps=fs.NUM_WARPS)
    y, dl = torch.empty_like(x), torch.empty_like(x)
    handles = {'spline_forward': kernels['forward'][grid](
        x, params, *bounds, consts, y, dl, B, F, **blocks)}
    gx, gp = torch.empty_like(x), torch.empty_like(params)
    handles['spline_backward'] = kernels['backward'][grid](
        x, params, *bounds, consts, y, dl, gx, gp, B, F, **blocks)
    torch.cuda.synchronize()
    for name, handle in handles.items():
        say(f'  {name}: {getattr(handle, "n_regs", "not reported")} '
            f'registers, {getattr(handle, "n_spills", "not reported")} '
            f'spills per thread; block {fs.BLOCK_B}x{fs.BLOCK_F}, '
            f'{fs.NUM_WARPS} warps')


def build_slice(device):
    """The bench configuration with the port's entry points."""
    from tfep_tpu_torch.nn.conditioners.made import generate_degrees
    from tfep_tpu_torch.nn.flows import MAF, SequentialFlow
    from tfep_tpu_torch.nn.transformers import NeuralSplineTransformer
    generator = torch.Generator().manual_seed(SEED)
    bound = np.ones(F)
    layers = [MAF.create(
        generator, generate_degrees(
            F, order='ascending' if i % 2 == 0 else 'descending'),
        transformer=NeuralSplineTransformer(-3.0 * bound, 3.0 * bound, K,
                                            device=device),
        device=device, dtype=torch.float32) for i in range(N_LAYERS)]
    flow = SequentialFlow.create(*layers, device=device)
    # Random weights: identity initialization zeroes the output gains,
    # which would make every spline the identity.
    with torch.no_grad():
        for p in flow.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=generator).to(p))
    frames = torch.randn(B, F, generator=generator).to(device)
    return flow, frames


def set_fused(flow, policy):
    for maf in flow.flows:
        maf.transformer.fused = policy


def slice_phase(flow, frames, n_steps):
    from tfep_tpu_torch.loss import boltzmann_kl_div_loss
    from tfep_tpu_torch.ops.spline import LAUNCHES

    n_params = sum(p.numel() for p in flow.parameters())
    say(f'  flow: {N_LAYERS} MAF layers, MADE widths '
        f'{flow[0].conditioner.dimension_in} -> '
        f'{flow[0].conditioner.dimensions_hidden} -> '
        f'{flow[0].conditioner.dimension_out}, {n_params} parameters')

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
        err, rel = rel_err(kern.double(), plain)
        say(f'  map {label}: max|kernel path - float64 unfused path| = '
            f'{err:.3e} (relative to scale {rel:.3e}, tolerance {MAP_TOL:g})')
        if not rel <= MAP_TOL:
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

    with torch.no_grad():
        y, ldj = flow(frames)
        x_back, ldj_inv = flow.inverse(y)
    rt_err, rt_rel = rel_err(x_back, frames)
    ldj_err = float((ldj + ldj_inv).abs().max())
    say(f'  round trip: max|inverse(forward(x)) - x| = {rt_err:.3e}, '
        f'max|ldj + ldj_inverse| = {ldj_err:.3e} (tolerance '
        f'{ROUND_TRIP_TOL:g} relative to scale)')
    if not (rt_rel <= ROUND_TRIP_TOL and ldj_err <= ROUND_TRIP_TOL *
            max(1.0, float(ldj.abs().max()))):
        raise AssertionError('round trip disagrees')
    return launches, train_step


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


def timing_phase(device, flow, frames, train_step, smi):
    from tfep_tpu_torch.ops import spline as fs
    # Four input sets of 44 MB each, more than the 50 MB L2 cache.
    sets = []
    for seed in range(4):
        x, params, *bounds = spline_inputs(False, device, 10 + seed)
        g = torch.Generator().manual_seed(20 + seed)
        gy = torch.randn(B, F, generator=g).to(device)
        gl = torch.randn(B, F, generator=g).to(device)
        sets.append((x, params, bounds, gy, gl))
    consts = (K, 1e-4, 1e-4)

    def k1(x, params, bounds, gy, gl):
        fs.launch_forward(x, params, *bounds, *consts)

    def k2(x, params, bounds, gy, gl):
        fs.launch_backward(x, params, *bounds, gy, gl, *consts)

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

    # The training step and the map evaluation, host clock around work
    # that ends in a synchronize.
    for _ in range(3):
        train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 20
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
    say(f'  training step: {step_ms:.3f} ms, {B / step_ms * 1e3:.0f} '
        f'frames/s at batch {B}; peak memory {peak / 2**20:.1f} MiB; '
        f'[{smi}]')
    say(f'  map evaluation (no grad): {eval_ms:.3f} ms, '
        f'{B / eval_ms * 1e3:.0f} frames/s; [{smi}]')
    return rows, dict(step_ms=step_ms, frames_per_s=B / step_ms * 1e3,
                      eval_ms=eval_ms, peak_bytes=peak)


def _timed_build(build):
    """``(path, seconds)`` of ``build()``, or the exception it raised."""
    t0 = time.perf_counter()
    try:
        return build(), time.perf_counter() - t0
    except BaseException as error:  # re-raised in the main thread
        return error


def profile_phase(train_step, step_ms, smi, n=5, batch=B):
    """Device time of the training step by kernel, from torch.profiler:
    the busy share of the step and the time by kind of kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(min(n, 3)):
        train_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            train_step()
        torch.cuda.synchronize()
    kinds = {}
    for event in prof.events():
        if event.device_type != DeviceType.CUDA:
            continue
        name = event.name.lower()
        if name in ('forward_kernel', 'backward_kernel'):
            kind = 'spline kernels (K1, K2)'
        elif 'egnn_kernel' in name or 'reduce_partials' in name:
            kind = 'EGNN kernels (K3, K4, K5)'
        elif any(s in name for s in ('gemm', 'xmma', 'cutlass', 'sm90_')):
            kind = 'matrix products (cuBLAS)'
        elif 'multi_tensor' in name or 'adam' in name:
            kind = 'optimizer'
        elif 'memcpy' in name or 'memset' in name:
            kind = 'copies'
        else:
            kind = 'other elementwise and reductions'
        count, us = kinds.get(kind, (0, 0.0))
        kinds[kind] = (count + 1, us + event.time_range.elapsed_us())
    busy_ms = sum(us for _, us in kinds.values()) / n / 1e3
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
    say(f'  tolerances: forward and tangent {EGNN_FORWARD_TOL:g}, '
        f'gradients {EGNN_BACKWARD_TOL:g}, relative to max(1, max|plain|) '
        '(float32 sums of 64 products in another order; the weight '
        'gradients sum over every pair of the batch)')
    for shape, spread in (((CNF_BATCH, N_ATOMS, CNF_FEAT, CNF_FEAT), 0.5),
                          ((7, 13, CNF_FEAT, CNF_FEAT), 4.0)):
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


def main():
    import threading

    import tfep_tpu_torch  # noqa: F401  (fails outside a checkout)
    from tfep_tpu_torch.ops import egnn

    say('[1] card')
    smi = card_phase()
    device = torch.device('cuda')
    # nvcc builds the EGNN kernels while the Triton phases run.
    built = []
    build_thread = threading.Thread(target=lambda: built.append(_timed_build(
        egnn.build)))
    build_thread.start()

    say('[2] kernels against their plain version (float32, bench shape)')
    t0 = time.perf_counter()
    errors = kernel_phase(device)
    say(f'  built and checked in {time.perf_counter() - t0:.1f} s')
    kernel_resources(device)

    say('[3] the slice: spline-MAF training step at the bench config')
    flow, frames = build_slice(device)
    launches, train_step = slice_phase(flow, frames, N_STEPS)

    say('[4] times')
    rows, step = timing_phase(device, flow, frames, train_step, smi)
    profile_phase(train_step, step['step_ms'], smi)
    del flow, frames, train_step
    torch.cuda.empty_cache()

    say('[5] EGNN kernels K3/K4/K5 against their plain version (float32)')
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

    say('[6] the CNF slice: cnf_bench training step, pairwise=fused')
    cnf, cnf_frames = build_cnf(device)
    cnf_launches, cnf_step = cnf_phase(cnf, cnf_frames)

    say('[7] CNF times')
    egnn_rows = egnn_timing_phase(device, smi)
    cnf_times = cnf_timing_phase(cnf, cnf_frames, cnf_step, smi)
    profile_phase(cnf_step, cnf_times['step_ms'], smi, n=2,
                  batch=CNF_BATCH)

    tpu = 'tfep_tpu/ops/pallas/spline.py'
    replaces = {'spline_forward': f'{tpu}:82 (_forward_kernel, launched '
                                  f'at {tpu}:304 from _fused_spline_fwd_impl '
                                  f'{tpu}:382)',
                'spline_backward': f'{tpu}:143 (_backward_kernel, launched '
                                   f'at {tpu}:304 from _fused_spline_bwd '
                                   f'{tpu}:407)'}
    kernels = []
    for row, which in zip(rows, ('forward', 'backward')):
        kernels.append({
            'name': row['name'], 'route': 'triton',
            'source': 'tfep_tpu_torch/ops/spline.py',
            'replaces': replaces[row['name']],
            'launches': launches[which],
            'max_abs_err': errors[which],
            'ms': row['ms'], 'plain_ms': row['plain_ms'],
            'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
            'library_ms': None})
    egnn_tpu = 'tfep_tpu/ops/pallas/egnn.py'
    egnn_replaces = {
        'egnn_forward': (f'{egnn_tpu}:113 (_forward_kernel, launched at '
                         f'{egnn_tpu}:495 from _fwd_impl {egnn_tpu}:484)',
                         'k3', 'K3'),
        'egnn_jvp': (f'{egnn_tpu}:193 (_jvp_kernel, launched at '
                     f'{egnn_tpu}:286 from _jvp_op {egnn_tpu}:264)',
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
                    'card': smi}))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
