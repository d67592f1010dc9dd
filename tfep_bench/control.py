#!/usr/bin/env python3
"""Readings of the control and of the planted faults, at a cell's own size.

    python3 tfep_bench/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--variants program tf32 half]

For each seed: the frames, the weights and the first steps' rows as a run
of the cell draws them; the plain reference (the configuration's
precision, float32 with TF32 off) against itself put in the program's
place (1) in TF32, the precision below the configuration's, and, for a
training cell, (2) on half of each batch, the mean taken over the rest.
The variant ``program`` reads the program's own numbers: a run of the cell
through the harness with the shortest window (one step, or one pass),
checked as every run is. Prints one JSON line per seed and variant with
the numbers a run compares. The benchmark's runs do not run this; its
limits are set from these readings (``PERF.md``).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed, device, variants):
    import torch

    from tfep_bench import checks, harness
    from tfep_bench import weights as draws

    cfg, traffic, ref = cell.cfg, cell.traffic, cell.reference
    dtype = getattr(torch, cfg['dtype'])
    frames = cell.adapter.frames(cfg, int(traffic['frames']), seed,
                                 device).to(dtype)
    weights = draws.draw(ref.weight_spec(ref.structure(cfg)), seed, device,
                         dtype=dtype)
    ctx = ref.context(cfg, frames)
    out = {}

    def tf32(on):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on

    if traffic['entry'] == 'evaluate':
        tf32(False)
        single = ref.evaluate(ctx, weights, frames)
        f64 = frames.double()
        double = ref.evaluate(ref.context(cfg, f64), {
            k: v.double() for k, v in weights.items()}, f64)
        if 'tf32' in variants:
            tf32(True)
            cu, cl = ref.evaluate(ctx, weights, frames)
            tf32(False)
            out['tf32'] = checks.evaluation_gaps([dict(
                potential=cu, log_det_J=cl,
                dataset_sample_index=list(range(len(cu))))], single, double)
        return out

    n = int(traffic['check_steps'])
    order = harness.batch_order(draws.sub_seed(seed, 'shuffle'),
                                len(frames), int(traffic['batch']), n)

    def batches(share=1.0):
        return [dict(positions=frames[torch.as_tensor(
            idx[:int(len(idx) * share)], device=device)],
            indices=idx[:int(len(idx) * share)], step=step)
            for step, idx in enumerate(order)]

    initial = harness.host_copy(weights)
    tf32(False)
    base = ref.train_steps(ctx, weights, batches())
    base = (base[0], harness.host_copy(base[1]), harness.host_copy(base[2]))
    for variant in variants:
        tf32(variant == 'tf32')
        got = ref.train_steps(ctx, weights, batches(
            0.5 if variant == 'half' else 1.0))
        tf32(False)
        got = (got[0], harness.host_copy(got[1]), harness.host_copy(got[2]))
        out[variant] = checks.training_gaps(got, base, initial)
    return out


def program_readings(cell, seed, device):
    """The numbers a run of the cell compares, from a run with the
    shortest window."""
    import time

    from tfep_bench import harness
    _, rows, _ = harness.run(cell, seed, 0.0, False, device,
                             time.perf_counter())
    return {name: value for name, value, _ in rows}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    parser.add_argument('--variants', nargs='+',
                        choices=('program', 'tf32', 'half'),
                        help='default: tf32, and half for a training cell')
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from tfep_bench import harness
    if not torch.cuda.is_available():
        sys.exit('control: no CUDA device is available.')
    cell = harness.Cell(args.workload)
    variants = args.variants or (
        ['tf32', 'half'] if cell.traffic['entry'] == 'fit' else ['tf32'])
    device = torch.device('cuda')

    def show(seed, variant, gaps):
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              variant=variant, gaps=gaps,
                              kind=torch.cuda.get_device_name(0))),
              flush=True)

    for seed in args.seeds:
        if 'program' in variants:
            show(seed, 'program', program_readings(cell, seed, device))
        rest = [v for v in variants if v != 'program']
        if rest:
            for variant, gaps in readings(cell, seed, device, rest).items():
                show(seed, variant, gaps)


if __name__ == '__main__':
    main()
