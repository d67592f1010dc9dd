#!/usr/bin/env python3
"""Where the forward EGNN kernel (K3, K4) spends its time, phase by phase.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python -m tfep_tpu_torch.tools.egnn_fwd_phases

It copies ``tfep_tpu_torch/csrc/egnn.cu``, adds ``clock64()`` counters at
the phase boundaries of ``egnn_fwd_kernel`` (located by the source's own
comments; the script stops if one is missing), builds the copy into
``build/phases``, launches K3 and K4 once each at the CNF bench shape
(B=256, n=32, F=D=64, float32), and prints, for each, the cycles per tile
of 32 pairs that a warp spends in each phase: tile start (distances,
staging of a_j), the three products with their epilogues, the messages
and their sums, and the row's end. The sums are per warp, so they show
what holds one warp back, not the SM's throughput; the counters add a
few instructions per phase. The kernel in the package is not changed.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
PHASES = ('tile start', 'P1: a_i + a_j + W_e emb', 'P2: W_m2 s, attention',
          'masked messages', 'message sums', 'P3: W_x1 msg, magnitude',
          'store magnitude', 'row end')

# (anchor in the source, the same text with a counter inserted).
MARKS = [
    ('  const int rows = a.B * n;\n',
     '  const int rows = a.B * n;\n  long long prof_[9] = {0};\n'
     '  long long last_ = clock64();\n  int tiles_ = 0;\n'),
    ('      // pre = a_i + a_j + W_e emb + b1,',
     '      PHASE(0);\n      ++tiles_;\n      // pre = a_i + a_j + W_e emb + b1,'),
    ('      // ms = silu(W_m2 s + b_m2),',
     '      PHASE(1);\n      // ms = silu(W_m2 s + b_m2),'),
    ('      // Masked messages, in place.',
     '      PHASE(2);\n      // Masked messages, in place.'),
    ("      // Their sums over the tile's senders",
     "      PHASE(3);\n      // Their sums over the tile's senders"),
    ('      // Magnitude: t = tanh(',
     '      PHASE(4);\n      // Magnitude: t = tanh('),
    ('      if (valid) {\n        const T t = d_tanh(u);',
     '      PHASE(5);\n      if (valid) {\n        const T t = d_tanh(u);'),
    ('      }\n    }\n    for (int f = lane; f < F; f += 32) {\n      a.nm[',
     '      }\n      PHASE(6);\n    }\n'
     '    for (int f = lane; f < F; f += 32) {\n      a.nm['),
    ('      if (kTangent) a.dnm[(size_t)r * F + f] = dnmacc[f];\n    }\n',
     '      if (kTangent) a.dnm[(size_t)r * F + f] = dnmacc[f];\n    }\n'
     '    PHASE(7);\n'),
]
KERNEL_END = '  }\n}\n\n// ========'
PRELUDE = ('__device__ unsigned long long g_phases[16];\n'
           '#define PHASE(i) { long long t_ = clock64(); '
           'prof_[i] += t_ - last_; last_ = t_; }\n')
SUMS = ('  if (threadIdx.x % 32 == 0) {\n'
        '    for (int q = 0; q < 9; ++q)\n'
        '      atomicAdd(&g_phases[q], (unsigned long long)prof_[q]);\n'
        '    atomicAdd(&g_phases[9], (unsigned long long)tiles_);\n'
        '  }\n')
READER = ('extern "C" int egnn_phases(unsigned long long* out, int reset) {\n'
          '  if (reset) {\n'
          '    unsigned long long zero[16] = {0};\n'
          '    return cudaMemcpyToSymbol(g_phases, zero, sizeof(zero));\n'
          '  }\n'
          '  return cudaMemcpyFromSymbol(out, g_phases, sizeof(zero_t));\n'
          '}\n')


def instrument(source: str) -> str:
    """``source`` with the phase counters added to egnn_fwd_kernel."""
    def once(text, anchor, new):
        if text.count(anchor) != 1:
            raise SystemExit(f'anchor not found once in egnn.cu: {anchor!r}')
        return text.replace(anchor, new)

    start = source.index('egnn_fwd_kernel(Args<T> a) {')
    end = source.index(KERNEL_END, start)
    kernel = source[start:end]
    for anchor, marked in MARKS:
        kernel = once(kernel, anchor, marked)
    kernel += '  }\n' + SUMS
    tail = source[end + len('  }\n'):]
    out = source[:start] + kernel + tail
    out = once(out, 'namespace {\n', 'namespace {\n' + PRELUDE)
    return out + '\ntypedef unsigned long long zero_t[16];\n' + READER


def main():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from tfep_tpu_torch.ops import egnn as E
    if not torch.cuda.is_available():
        raise SystemExit('egnn_fwd_phases: no CUDA device is available.')
    smi = chip_smoke.card_phase()
    build = ROOT / 'build' / 'phases'
    build.mkdir(parents=True, exist_ok=True)
    src = build / 'egnn_phases.cu'
    src.write_text(instrument(E._SOURCE.read_text()))
    lib_path = build / 'libegnn_phases.so'
    done = subprocess.run(
        [E._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
         '-O3', '-shared', '-Xcompiler', '-fPIC', '-o', str(lib_path),
         str(src)], capture_output=True, text=True)
    if done.returncode != 0:
        raise SystemExit(f'nvcc failed:\n{done.stderr}')
    E.build = lambda: lib_path
    lib = E._library()
    lib.egnn_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    device = torch.device('cuda')
    shape = (chip_smoke.CNF_BATCH, chip_smoke.N_ATOMS, chip_smoke.CNF_FEAT,
             chip_smoke.CNF_FEAT)
    primals, tangents, _ = chip_smoke.egnn_inputs(*shape, device, 30)
    for label, launch in (
            ('K3', lambda: E.launch_k3(*primals,
                                       r_cutoff=chip_smoke.R_CUTOFF)),
            ('K4', lambda: E.launch_k4(*primals, *tangents,
                                       r_cutoff=chip_smoke.R_CUTOFF))):
        launch()
        torch.cuda.synchronize()
        lib.egnn_phases(None, 1)
        launch()
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * 16)()
        lib.egnn_phases(out, 0)
        tiles, total = out[9], sum(out[:8])
        cfg = E.forward_config(torch.float32, label == 'K4', *shape)
        print(f'{label} at B,n,F,D={shape}: {cfg["warps_per_block"]} warps '
              f'per block, {tiles} tiles, {total / tiles:.0f} cycles per '
              f'tile and warp; [{smi}]')
        for name, cycles in zip(PHASES, out[:8]):
            print(f'  {name:26s} {cycles / tiles:9.0f} cycles  '
                  f'{100 * cycles / total:5.1f}%')


if __name__ == '__main__':
    main()
