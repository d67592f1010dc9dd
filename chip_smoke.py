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


def profile_phase(train_step, step_ms, smi):
    """Device time of the training step by kernel, from torch.profiler:
    the busy share of the step and the time by kind of kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = 5
    for _ in range(3):
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
    lines = [smi, f'training step, batch {B}, {n} steps profiled; '
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


def main():
    import tfep_tpu_torch  # noqa: F401  (fails outside a checkout)

    say('[1] card')
    smi = card_phase()
    device = torch.device('cuda')

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
    say(json.dumps({'eager_launch_ms': {r['name']: r['eager_ms']
                                        for r in rows},
                    'train_step_ms': step['step_ms'],
                    'train_frames_per_s': step['frames_per_s'],
                    'eval_ms': step['eval_ms'],
                    'peak_memory_bytes': step['peak_bytes'],
                    'card': smi}))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
