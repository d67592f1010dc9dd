#!/usr/bin/env python3
"""Run one cell of the benchmark of ``tfep_tpu_torch`` on this machine's card.

    python3 tfep_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a ``torch.profiler``
trace of a fixed number of steps. The last line of the standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``: each
number checked against the reference beside its limit); the numbers
compared also end the standard error. Exits non-zero, with no result,
without a CUDA card, with fewer cards than the cell asks for, or when the
process holds JAX or the JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches():
    """The program's kernel caches inside the checkout, at fixed paths."""
    build = ROOT / 'build'
    os.environ['TRITON_CACHE_DIR'] = str(build / 'triton')
    os.environ['TRITON_HOME'] = str(build)
    os.environ['TORCH_EXTENSIONS_DIR'] = str(build / 'torch_extensions')
    os.environ['USE_FLAX'] = '0'


def _power_limit():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits'], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    _caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from tfep_bench import harness

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available():
        sys.exit('tfep_bench: no CUDA device is available.')
    if torch.cuda.device_count() < cell.chips:
        sys.exit(f'tfep_bench: the cell needs {cell.chips} cards, this '
                 f'machine has {torch.cuda.device_count()}.')
    torch.cuda.reset_peak_memory_stats()
    card = dict(kind=torch.cuda.get_device_name(0),
                power_limit_w=_power_limit())
    result, rows, record = harness.run(cell, args.seed, args.seconds,
                                       bool(args.trace), 'cuda', T_START,
                                       card)
    found = harness.banned_modules()
    if found:
        sys.exit(f'tfep_bench: the process holds {found} after the window.')
    times = record['intervals_ms'] or record.get('pass_ms', [])
    print(f'window: {record["window_s"]!r} s, {record["steps"]} steps, '
          f'set-up {record["setup_s"]!r} s; ms a step (a pass in an '
          f'evaluation): {[round(t, 1) for t in times]}', file=sys.stderr)
    for name, value, limit in rows:
        print(f'{name}: {value!r} (limit {limit!r})', file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == '__main__':
    main()
