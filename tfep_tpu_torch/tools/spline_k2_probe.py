#!/usr/bin/env python3
"""How close the spline's backward kernel (K2) comes to what its memory
traffic allows, and what it spends besides.

Run from the root of a checkout, on a machine with a CUDA card:

    python -m tfep_tpu_torch.tools.spline_k2_probe [SPLINE_PY ...]
        [--layouts BxFxW ...]

At the MAF bench shape (B=4096, F=96, K=8, float32) it prints, for K2 of
each SPLINE_PY (default: ``tfep_tpu_torch/ops/spline.py``; another
checkout's copy compares two versions in one run, in turns):

(a) K2's device time, as ``chip_smoke.graph_ms`` takes it (a CUDA graph of
    64 launches over 4 input sets, together larger than the L2 cache);
(b) the time of a copy probe: a Triton kernel with K2's grid and tile that
    reads x, params, gy, gl and the four bound rows once each and writes
    gx and gparams, with no arithmetic but what keeps the loads alive.
    Its bytes are K2's least bytes (``backward_bytes``), so it is the best
    K2's access pattern can do on this card;
(c) K2's registers and spills per thread, as Triton reports them;
(d) from the compiled code, per element: the PTX special-function and
    division instructions and, where ``cuobjdump`` runs, the SASS
    ``MUFU.EX2``, ``MUFU.LG2`` and ``MUFU.RCP`` instructions.

``--layouts 4x32x4 2x64x4`` also times this checkout's K2 and the copy
probe with other tiles (rows x features x warps), each checked against
the plain version first; ``--features 90`` takes another F.
"""

from __future__ import annotations

import argparse
import importlib.util
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from tfep_tpu_torch.ops import spline as fs

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / 'tfep_tpu_torch' / 'ops' / 'spline.py'


def probe_shapes(B: int, F: int, K: int) -> dict:
    """What the copy probe reads and writes: K2's inputs and outputs."""
    row, params = (B, F), (B, (3 * K + 1) * F)
    return {'reads': dict(x=row, params=params, gy=row, gl=row, x0=(F,),
                          xf=(F,), y0=(F,), yf=(F,)),
            'writes': dict(gx=row, gparams=params)}


def probe_bytes(B: int, F: int, K: int, itemsize: int) -> int:
    """Bytes the copy probe moves: each input read once, each output
    written once."""
    shapes = probe_shapes(B, F, K)
    return itemsize * sum(math.prod(s) for group in shapes.values()
                          for s in group.values())


def parse_layout(text: str) -> dict:
    """``'4x32x4'`` -> rows, features and warps of a program's tile. For
    the copy probe a suffix ``a`` asks for aligned (16-byte) accesses and
    ``pN`` for a persistent grid with loads pipelined over N tiles."""
    match = re.fullmatch(r'(\d+)x(\d+)x(\d+)(a?)(?:p(\d+))?', text)
    if match is None:
        raise argparse.ArgumentTypeError(f'{text}: expected BxFxW[a][pN]')
    block_b, block_f, warps = (int(v) for v in match.groups()[:3])
    for v in (block_b, block_f, warps):
        if v < 1 or v & (v - 1):
            raise argparse.ArgumentTypeError(f'{text}: powers of two only')
    layout = dict(BLOCK_B=block_b, BLOCK_F=block_f, num_warps=warps)
    if match.group(4):
        layout['aligned'] = True
    if match.group(5):
        layout['stages'] = int(match.group(5))
    return layout


def layout_name(layout: dict) -> str:
    return (f"{layout['BLOCK_B']}x{layout['BLOCK_F']}x{layout['num_warps']}"
            + ('a' if layout.get('aligned') else '')
            + (f"p{layout['stages']}" if layout.get('stages') else ''))


# Instructions counted in the compiled kernel, per element.
PTX_COUNTS = (('ex2.approx', r'\bex2\.approx'),
              ('lg2.approx', r'\blg2\.approx'), ('rcp', r'\brcp\.'),
              ('div', r'\bdiv\.(?:full|rn|approx)\.f'))
SASS_COUNTS = (('MUFU.EX2', r'\bMUFU\.EX2\b'), ('MUFU.LG2', r'\bMUFU\.LG2\b'),
               ('MUFU.RCP', r'\bMUFU\.RCP\b'), ('CALL', r'\bCALL\.'))
SASS_INSTRUCTION = re.compile(r'/\*[0-9a-f]{4}\*/\s+\S')

_PROBE = {}


def _copy_kernel(aligned: bool):
    """The copy probe, built at its first launch (Triton imported here).

    As K2, B and F are not specialised, so accesses stay 4-byte;
    ``aligned`` specialises them, so where F is a multiple of 16 and the
    tile gives a thread 4 elements along F, Triton makes them 16-byte.
    """
    if _PROBE:
        return _PROBE[aligned]
    global tl, copy_tile
    import triton
    import triton.language as tl

    @triton.jit
    def copy_tile(rt, ct, x_ptr, p_ptr, x0_ptr, xf_ptr, y0_ptr, yf_ptr,
                  gy_ptr, gl_ptr, gx_ptr, gp_ptr, B, F, K: tl.constexpr,
                  KP: tl.constexpr, BLOCK_B: tl.constexpr,
                  BLOCK_F: tl.constexpr):
        # K2's axes: rows, bins, features.
        rows = (rt * BLOCK_B + tl.arange(0, BLOCK_B))[:, None, None]
        cols = (ct * BLOCK_F + tl.arange(0, BLOCK_F))[None, None, :]
        kk = tl.arange(0, KP)[None, :, None]
        cmask = cols < F
        m = (rows < B) & cmask
        mk = m & (kk < K)
        xy = rows * F + cols
        prow = rows * ((3 * K + 1) * F) + cols
        bound = (tl.load(x0_ptr + cols, mask=cmask, other=0.0)
                 + tl.load(xf_ptr + cols, mask=cmask, other=0.0)
                 + tl.load(y0_ptr + cols, mask=cmask, other=0.0)
                 + tl.load(yf_ptr + cols, mask=cmask, other=0.0))
        gx = (tl.load(x_ptr + xy, mask=m, other=0.0)
              + tl.load(gy_ptr + xy, mask=m, other=0.0)
              + tl.load(gl_ptr + xy, mask=m, other=0.0) + bound)
        tl.store(gx_ptr + xy, gx, mask=m)
        for j in tl.static_range(3):  # widths, heights, slopes 0..K-1
            off = prow + (j * K) * F + kk * F
            tl.store(gp_ptr + off, tl.load(p_ptr + off, mask=mk), mask=mk)
        off = prow + 3 * K * F  # slope K
        tl.store(gp_ptr + off, tl.load(p_ptr + off, mask=m), mask=m)

    def copy_kernel(x_ptr, p_ptr, x0_ptr, xf_ptr, y0_ptr, yf_ptr, gy_ptr,
                    gl_ptr, gx_ptr, gp_ptr, B, F, K: tl.constexpr,
                    KP: tl.constexpr, BLOCK_B: tl.constexpr,
                    BLOCK_F: tl.constexpr, STAGES: tl.constexpr):
        if STAGES == 0:  # one tile per program, K2's grid
            copy_tile(tl.program_id(0), tl.program_id(1), x_ptr, p_ptr,
                      x0_ptr, xf_ptr, y0_ptr, yf_ptr, gy_ptr, gl_ptr, gx_ptr,
                      gp_ptr, B, F, K, KP, BLOCK_B, BLOCK_F)
        else:  # persistent: K2's tiles in K2's order, loads pipelined
            n_b = tl.cdiv(B, BLOCK_B)
            for tile in tl.range(tl.program_id(0), n_b * tl.cdiv(F, BLOCK_F),
                                 tl.num_programs(0), num_stages=STAGES):
                copy_tile(tile % n_b, tile // n_b, x_ptr, p_ptr, x0_ptr,
                          xf_ptr, y0_ptr, yf_ptr, gy_ptr, gl_ptr, gx_ptr,
                          gp_ptr, B, F, K, KP, BLOCK_B, BLOCK_F)

    _PROBE[False] = triton.jit(do_not_specialize=['B', 'F'])(copy_kernel)
    _PROBE[True] = triton.jit(copy_kernel)
    return _PROBE[aligned]


def launch_probe(x, params, bounds, gy, gl, n_bins, layout):
    """One copy probe over K2's inputs; returns the launch handle.
    ``layout``: a K2 tile, optionally with ``aligned`` and ``stages``
    (see :func:`parse_layout`)."""
    B, F = x.shape
    gx = torch.empty_like(x)
    gp = torch.empty_like(params)
    tile = {k: layout[k] for k in ('BLOCK_B', 'BLOCK_F', 'num_warps')}
    grid = fs._grid(B, F, tile['BLOCK_B'], tile['BLOCK_F'])
    stages = layout.get('stages', 0)
    if stages:
        # As many programs as fit on the card at once (2048 threads an
        # SM), each walking tiles.
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        grid = (min(grid[0] * grid[1],
                    sms * 2048 // (32 * tile['num_warps'])),)
    return _copy_kernel(layout.get('aligned', False))[grid](
        x, params, *bounds, gy, gl, gx, gp, B, F, K=n_bins,
        KP=fs._padded_bins(n_bins), STAGES=stages, **tile)


def _load(path: Path, index: int):
    """``spline.py`` at ``path`` as a module of its own."""
    if path.resolve() == SOURCE.resolve():
        return fs
    spec = importlib.util.spec_from_file_location(f'spline_k2_{index}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_ALIGNED = {}


def run_backward(fs, x, params, bounds, gy, gl, n_bins, layout=None):
    """Launch ``fs``'s K2 once; returns Triton's handle (registers, spills,
    compiled code), ``grad_x`` and ``grad_params``. ``layout``: a tile of
    :func:`parse_layout`, where ``aligned`` compiles K2 with B and F
    specialised (16-byte accesses where F allows), launched through
    ``fs._backward_launch(kernel=...)``: an older source without that
    argument is probed aligned by its own checkout's probe. Sources before
    the one-pass K2 had one tile for both kernels and no layout
    argument."""
    consts = fs._constants(x.device, x.dtype, 1e-4, 1e-4)
    gx, gp = torch.empty_like(x), torch.empty_like(params)
    B, F = x.shape
    if not hasattr(fs, '_backward_launch'):
        handle = fs._kernels()['backward'][fs._grid(B, F)](
            x, params, *bounds, consts, gy, gl, gx, gp, B, F, K=n_bins,
            BLOCK_B=fs.BLOCK_B, BLOCK_F=fs.BLOCK_F, num_warps=fs.NUM_WARPS)
        return handle, gx, gp
    layout = dict(layout or fs.BACKWARD_LAYOUT)
    if not layout.pop('aligned', False):
        return (fs._backward_launch(x, params, bounds, consts, gy, gl, gx,
                                    gp, n_bins, layout), gx, gp)
    if fs not in _ALIGNED:
        import triton
        _ALIGNED[fs] = triton.jit(fs._kernels()['backward'].fn)
    return (fs._backward_launch(x, params, bounds, consts, gy, gl, gx, gp,
                                n_bins, layout, kernel=_ALIGNED[fs]), gx, gp)


def default_layout(fs) -> dict:
    if hasattr(fs, 'BACKWARD_LAYOUT'):
        return dict(fs.BACKWARD_LAYOUT)
    return dict(BLOCK_B=fs.BLOCK_B, BLOCK_F=fs.BLOCK_F,
                num_warps=fs.NUM_WARPS)


def _cuobjdump():
    try:
        import triton
        bundled = (Path(triton.__file__).parent / 'backends' / 'nvidia'
                   / 'bin' / 'cuobjdump')
        if bundled.exists():
            return str(bundled)
    except ImportError:
        pass
    for candidate in (shutil.which('cuobjdump'),
                      '/usr/local/cuda/bin/cuobjdump'):
        if candidate and Path(candidate).exists():
            return candidate
    return None


def instruction_counts(handle, name: str) -> dict:
    """Special-function and division instructions in ``handle``'s code;
    SASS counts are ``None`` where ``cuobjdump`` does not run."""
    ptx = handle.asm['ptx']
    counts = {k: len(re.findall(p, ptx)) for k, p in PTX_COUNTS}
    tool = _cuobjdump()
    sass = None
    if tool is not None:
        out = ROOT / 'build' / 'k2_probe'
        out.mkdir(parents=True, exist_ok=True)
        cubin = out / f'{name}.cubin'
        cubin.write_bytes(handle.asm['cubin'])
        done = subprocess.run([tool, '-sass', str(cubin)],
                              capture_output=True, text=True)
        if done.returncode == 0:
            sass = done.stdout
    for k, p in SASS_COUNTS:
        counts[k] = None if sass is None else len(re.findall(p, sass))
    counts['SASS'] = (None if sass is None
                      else len(SASS_INSTRUCTION.findall(sass)))
    return counts


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('sources', nargs='*', type=Path, default=[SOURCE],
                        help="spline.py files whose K2 to time (default: "
                        "this checkout's)")
    parser.add_argument('--layouts', nargs='*', type=parse_layout,
                        default=[], help="more tiles for this checkout's "
                        'K2 and the copy probe, as rows x features x warps')
    parser.add_argument('--probes', nargs='*', type=parse_layout,
                        default=[], help='more tiles for the copy probe '
                        'alone, with suffixes a (aligned) and pN '
                        '(persistent, N stages)')
    parser.add_argument('--features', type=int, default=None,
                        help='F, the features per row (default: the MAF '
                        "bench's 96)")
    args = parser.parse_args(argv)
    for layout in args.layouts:
        if 'stages' in layout:
            parser.error('K2 has no persistent form: pN goes to --probes')
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    if not torch.cuda.is_available():
        raise SystemExit('spline_k2_probe: no CUDA device is available.')
    smi = chip_smoke.card_phase()
    device = torch.device('cuda')
    B, K = chip_smoke.B, chip_smoke.K
    F = args.features or chip_smoke.F
    modules = [_load(p, i) for i, p in enumerate(args.sources)]
    sets = chip_smoke.spline_sets(device, F)

    # The plain version's gradients on set 0, for each variant's check.
    x, params, bounds, gy, gl = sets[0]
    xi, pi = x.clone().requires_grad_(), params.clone().requires_grad_()
    ref = torch.autograd.grad(
        fs.fused_spline_reference(xi, pi, *bounds, K), (xi, pi), (gy, gl))

    # (label, module, layout; None: the module's own) of each K2 timed.
    variants = [(str(p), mod, None)
                for p, mod in zip(args.sources, modules)]
    variants += [(f'K2 at {layout_name(lay)}', fs, lay)
                 for lay in args.layouts]
    probes = []
    for layout in [default_layout(fs)] + args.layouts + args.probes:
        if layout not in [p[1] for p in probes]:
            probes.append((f'copy probe at {layout_name(layout)}', layout,
                           lambda *s, lay=layout: launch_probe(*s, K, lay)))

    print(f'K2 at B={B}, F={F}, K={K}, float32; [{smi}]')
    timed = []
    for i, (label, mod, layout) in enumerate(variants):
        handle, *got = run_backward(mod, *sets[0], K, layout)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                  for a, b in zip(got, ref))
        layout = layout or default_layout(mod)
        per_thread = (layout['BLOCK_B'] * layout['BLOCK_F']
                      / (32 * layout['num_warps']))
        counts = instruction_counts(handle, f'k2_{i}')
        shown = ', '.join(
            f'{k} {v / per_thread:g}' if v is not None else f'{k} not '
            'measured' for k, v in counts.items())
        print(f'  {label}: tile {layout_name(layout)} ({per_thread:g} '
              f'elements per thread); {handle.n_regs} registers, '
              f'{handle.n_spills} spills per thread; max error against the '
              f'plain version, relative to max(1, max|plain|), {err:.3e}')
        print(f'    per element: {shown}')
        for line in handle.asm['ttgir'].splitlines():
            if line.startswith('#blocked'):
                print(f'    {line}')
        timed.append((label, lambda *s, mod=mod, lay=variants[i][2]:
                      run_backward(mod, *s, K, lay)))
    for label, layout, launch in probes:
        handle = launch(*sets[0])
        torch.cuda.synchronize()
        print(f'  {label}: {handle.n_regs} registers, {handle.n_spills} '
              'spills per thread')

    nbytes = fs.backward_bytes(B, F, K, 4)
    assert probe_bytes(B, F, K, 4) == nbytes
    bound = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
    timed += [(label, launch) for label, _, launch in probes]
    runs = {label: [] for label, _ in timed}
    for label, launch in timed + timed[::-1]:  # in turns, A B .. B A
        runs[label].append(chip_smoke.graph_ms(launch, sets, 64, 5))
    print(f'  times (CUDA graph, 64 launches x 5 replays, runs in turns); '
          f'bound {bound:.5f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s)')
    for label, _ in timed:
        ms = sum(runs[label]) / 2
        print(f'  {label}: {ms:.5f} ms (runs '
              f"{', '.join(f'{r:.5f}' for r in runs[label])}); "
              f'{100 * bound / ms:.1f}% of the bound, '
              f'{nbytes / ms / 1e9:.3f} TB/s')


if __name__ == '__main__':
    main()
