"""The host side of ``tfep_tpu_torch/tools/spline_k2_probe.py`` on the CPU:
the copy probe moves exactly K2's least bytes, the tile arguments parse,
and the tool imports without Triton (which it imports only where it
launches a kernel)."""

import argparse
import subprocess
import sys
from pathlib import Path

import pytest

from tfep_tpu_torch.ops import spline as fs
from tfep_tpu_torch.tools import spline_k2_probe as probe

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize('shape', [(4096, 96, 8), (37, 13, 5), (1, 97, 3),
                                   (33, 13, 16)])
@pytest.mark.parametrize('itemsize', [4, 8])
def test_copy_probe_moves_k2s_least_bytes(shape, itemsize):
    B, F, K = shape
    assert probe.probe_bytes(B, F, K, itemsize) == fs.backward_bytes(
        B, F, K, itemsize)


def test_copy_probe_reads_and_writes_k2s_arguments():
    shapes = probe.probe_shapes(4096, 96, 8)
    assert set(shapes['reads']) == {'x', 'params', 'gy', 'gl', 'x0', 'xf',
                                    'y0', 'yf'}
    assert shapes['writes'] == {'gx': (4096, 96), 'gparams': (4096, 2400)}


def test_layouts_parse_and_default_to_k2s_tile():
    assert probe.parse_layout('2x64x4') == dict(BLOCK_B=2, BLOCK_F=64,
                                                num_warps=4)
    assert probe.layout_name(fs.BACKWARD_LAYOUT) == '4x32x4'
    assert probe.default_layout(fs) == fs.BACKWARD_LAYOUT
    with pytest.raises(argparse.ArgumentTypeError):
        probe.parse_layout('3x32x4')


@pytest.mark.parametrize('K, KP', [(1, 1), (3, 4), (4, 4), (5, 8), (8, 8),
                                   (16, 16)])
def test_padded_bins(K, KP):
    assert fs._padded_bins(K) == KP


def test_k2s_tile_has_one_element_per_thread():
    layout = fs.BACKWARD_LAYOUT
    assert layout['BLOCK_B'] * layout['BLOCK_F'] == 32 * layout['num_warps']


def test_tool_imports_without_triton():
    code = ('import sys; sys.modules["triton"] = None\n'
            'import tfep_tpu_torch.tools.spline_k2_probe as p\n'
            # x, gy, gl, gx; params, gparams; four bound rows
            'assert p.probe_bytes(4, 3, 2, 4) == 4 * (4 * 12 + 2 * 84 + 12)\n')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)
