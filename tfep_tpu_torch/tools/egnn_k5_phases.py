#!/usr/bin/env python3
"""Where the EGNN backward kernel (K5) spends its time, phase by phase.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python -m tfep_tpu_torch.tools.egnn_k5_phases [SOURCE ...]

For each SOURCE (default: ``tfep_tpu_torch/csrc/egnn.cu``; another
checkout's copy compares two versions in one run) it copies the file,
adds ``clock64()`` counters at the phase boundaries of ``egnn_kernel``
(located by the source's own comments; the script stops if one is not
found exactly once), builds the copies into ``build/phases`` (all at
once), launches K5 once at the CNF bench shape (B=256, n=32, F=D=64,
float32) and prints the cycles per tile that a block spends in each
phase: the tile start, the radial expansion, the nine products with
their epilogues (P1-P9) and the phases between them (C-M). Every phase
ends at a ``__syncthreads()``, so thread 0's clock measures the block;
the counters add a few instructions per phase. The kernel in the
package is not changed.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / 'tfep_tpu_torch' / 'csrc' / 'egnn.cu'

# (phase that ends at the anchor, anchors): a counter goes in before the
# anchor, which must occur exactly once in egnn_kernel. Where a phase has
# two anchors, the first one found is used: the second is the text of
# sources written before the comment.
MARKS = [
    ('tile start', ('      // Radial expansion (and its tangent',)),
    ('radial expansion', ('      // pre = a_i + a_j + W_e emb + b1,',)),
    ('P1: W_e emb -> pre, s', ('      // m1 = W_m2 s + b_m2,',)),
    ('P2: W_m2 s -> m1, ms', ('      // Attention per pair',)),
    ('C: attention logit', ('      // Masked messages.',)),
    ('D: masked messages', ('      // z1 = W_x1 msg + b_x1;',)),
    ('P3: W_x1 msg -> z1', ('      // Magnitudes: t = tanh(',)),
    ('E: magnitudes', ('        // ---- K5: the VJP of the tile',)),
    ('cotangents of q, u', ('        // z1, dz1 -> their cotangents',)),
    ('G: z1 cotangents, w_x2, b_x1', ('        // grad W_x1 += ',)),
    ('P4: grad W_x1', ('        // Cotangents of msg and dmsg',)),
    ('P5: msg cotangents',
     ('        // Cotangents of the attention logit',)),
    ('H: attention cotangents', ('        // Sums for w_att and b_att;',)),
    ('I: m1 cotangents, w_att, b_att', ('        // grad W_m2 += ',)),
    ('P6, J: grad W_m2, b_m2',
     ('        // Cotangents of s, ds, then of pre',)),
    ('P7: s cotangents', ('        // Sums into b1, a_i, da_i',)),
    ('K, P8: b1, a_i, a_j, grad W_e',
     ('        // Cotangents of emb and demb',)),
    ('P9: emb cotangents', ('        // The radial chain: sums for mu',)),
    ('L: radial chain', ('        // Distance gradients: ',
                         '        for (int p = tid; p < pt; p += nt) {\n'
                         '          const int j = j0 + p;\n'
                         '          if (j < n) {\n'
                         '            T gd = T(0), gdd = T(0);')),
    ('M: distance gradients',
     ('        __syncthreads();\n      }\n    }\n  }\n',)),
]
PHASES = tuple(name for name, _ in MARKS)
TILES = ('  for (int i = 0; i < n; ++i) {\n'
         '    for (int j0 = 0; j0 < n; j0 += pt) {\n')
KERNEL = 'egnn_kernel(Args<T> a) {'
KERNEL_END = '\n}\n\n// out[e] = sum over the frames'
PRELUDE = ('__device__ unsigned long long g_phases[32];\n'
           '#define PHASE(i) { long long t_ = clock64(); '
           'prof_[i] += t_ - last_; last_ = t_; }\n')
SUMS = (f'  if (threadIdx.x == 0) {{\n'
        f'    for (int q = 0; q < {len(MARKS)}; ++q)\n'
        f'      atomicAdd(&g_phases[q], (unsigned long long)prof_[q]);\n'
        f'    atomicAdd(&g_phases[31], (unsigned long long)tiles_);\n'
        f'  }}\n')
READER = ('\ntypedef unsigned long long phases_t[32];\n'
          'extern "C" int egnn_phases(unsigned long long* out, int reset) {\n'
          '  if (reset) {\n'
          '    unsigned long long zero[32] = {0};\n'
          '    return cudaMemcpyToSymbol(g_phases, zero, sizeof(zero));\n'
          '  }\n'
          '  return cudaMemcpyFromSymbol(out, g_phases, sizeof(phases_t));\n'
          '}\n')


def _once(text, anchors):
    for anchor in anchors:
        if text.count(anchor) == 1:
            return anchor
    raise SystemExit(f'anchor not found once in egnn_kernel: {anchors!r}')


def instrument(source: str) -> str:
    """``source`` with the phase counters added to egnn_kernel."""
    start = source.index(KERNEL)
    end = source.index(KERNEL_END, start)
    kernel = source[start:end]
    anchor = _once(kernel, (TILES,))
    # The sums stay in local memory (volatile): 20 more live registers
    # would push the products of a kernel near 255 into spilling.
    kernel = kernel.replace(
        anchor, f'  volatile long long prof_[{len(MARKS)}] = {{0}};\n'
        '  long long last_ = clock64();\n  int tiles_ = 0;\n' + anchor
        + '      ++tiles_;\n')
    for q, (_, anchors) in enumerate(MARKS):
        anchor = _once(kernel, anchors)
        if q == len(MARKS) - 1:  # the tile's last barrier
            cut = anchor.index('\n') + 1
            new = anchor[:cut] + f'        PHASE({q});\n' + anchor[cut:]
        else:
            new = f'      PHASE({q});\n' + anchor
        kernel = kernel.replace(anchor, new)
    out = source[:start] + kernel + '\n' + SUMS + source[end:]
    anchor = _once(out, ('namespace {\n',))
    return out.replace(anchor, anchor + PRELUDE) + READER


def _build(source: Path, index: int) -> Path:
    from tfep_tpu_torch.ops import egnn as E
    build = ROOT / 'build' / 'phases'
    build.mkdir(parents=True, exist_ok=True)
    src = build / f'egnn_k5_phases_{index}.cu'
    src.write_text(instrument(source.read_text()))
    lib = build / f'libegnn_k5_phases_{index}.so'
    done = subprocess.run(
        [E._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
         '-O3', '-shared', '-Xcompiler', '-fPIC', '-o', str(lib), str(src)],
        capture_output=True, text=True)
    if done.returncode != 0:
        raise SystemExit(f'nvcc failed for {source}:\n{done.stderr}')
    return lib


def _bind(path: Path):
    """The instrumented library, bound as ``ops/egnn.py`` binds K5, and
    made the one that ``launch_k5`` calls."""
    from tfep_tpu_torch.ops import egnn as E
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.egnn_k5.argtypes = [i32, i32, ptr, ptr, ptr, i32, i32, i32, i32,
                            ctypes.c_double, ptr]
    lib.egnn_k5.restype = i32
    lib.egnn_error_string.argtypes = [i32]
    lib.egnn_error_string.restype = ctypes.c_char_p
    lib.egnn_phases.argtypes = [ptr, i32]
    lib.egnn_phases.restype = i32
    E._LIB[:] = [lib]
    return lib


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('sources', nargs='*', type=Path, default=[SOURCE],
                        help='egnn.cu files to instrument (default: this '
                        "checkout's)")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tfep_tpu_torch.ops import egnn as E
    if not torch.cuda.is_available():
        raise SystemExit('egnn_k5_phases: no CUDA device is available.')
    smi = chip_smoke.card_phase()
    with ThreadPoolExecutor(len(args.sources)) as pool:
        libs = list(pool.map(_build, args.sources, range(len(args.sources))))
    shape = (chip_smoke.CNF_BATCH, chip_smoke.N_ATOMS, chip_smoke.CNF_FEAT,
             chip_smoke.CNF_FEAT)
    primals, tangents, cots = chip_smoke.egnn_inputs(
        *shape, torch.device('cuda'), 30)
    for source, path in zip(args.sources, libs):
        lib = _bind(path)

        def launch():
            E.launch_k5(*primals, *tangents, *cots,
                        r_cutoff=chip_smoke.R_CUTOFF)
            torch.cuda.synchronize()

        launch()
        lib.egnn_phases(None, 1)
        launch()
        out = (ctypes.c_ulonglong * 32)()
        status = lib.egnn_phases(out, 0)
        if status != 0:
            raise SystemExit(f'reading the counters failed: {status}')
        tiles, total = out[31], sum(out[:len(PHASES)])
        print(f'K5 ({source}) at B,n,F,D={shape}, float32: {tiles} tiles, '
              f'{total / tiles:.0f} cycles per tile and block; [{smi}]')
        for name, cycles in zip(PHASES, out[:len(PHASES)]):
            print(f'  {name:32s} {cycles / tiles:9.0f} cycles  '
                  f'{100 * cycles / total:5.1f}%')


if __name__ == '__main__':
    main()
