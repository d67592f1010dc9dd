"""K2's Triton source (``backward_kernel`` in ``tfep_tpu_torch/ops/spline.py``)
and K2's copy probe (``tfep_tpu_torch/tools/spline_k2_probe.py``) run on
the CPU, program by program, through a stand-in for ``triton.language``
on torch tensors, against the plain version's autograd.

Triton is not installed here, and Triton's own interpreter needs it. The
stand-in implements the part of ``triton.language`` those kernels use,
with Triton's semantics (masked loads and stores, reductions and prefix
sums along an axis, ``static_range``), so K2's logic (the padded bins, the
bin choice, the masked sums, the gradient terms, the ragged edges) is
checked on every run of the tests; what it cannot check (compilation,
layouts, approximate ``exp`` and division) the card tests in
``tests/test_torch_spline_cuda.py`` do.
"""

import builtins
import contextlib
import itertools
import sys
import types

import pytest
import torch

from tfep_tpu_torch.ops import spline as fs
from tfep_tpu_torch.tools import spline_k2_probe as probe

from test_torch_spline_cuda import TOLERANCES, _inputs


class _Ptr:
    """A pointer: a flat tensor and an offset (an int or an int tensor)."""

    def __init__(self, base, off):
        self.base, self.off = base, off

    def __add__(self, other):
        return _Ptr(self.base, self.off + other)

    __radd__ = __add__


def _language():
    tl = types.ModuleType('triton.language')
    tl.constexpr = object
    state = dict(pid=(0, 0), grid=(1, 1))

    def as_tensor(v, like):
        if isinstance(v, torch.Tensor):
            return v
        return torch.as_tensor(v, dtype=like.dtype if isinstance(
            like, torch.Tensor) and isinstance(v, float) else None)

    def load(ptr, mask=None, other=None):
        if mask is None:
            return ptr.base[ptr.off]
        off, mask = torch.broadcast_tensors(torch.as_tensor(ptr.off), mask)
        vals = ptr.base[torch.where(mask, off, 0)]
        # Lanes the mask drops read NaN unless ``other`` is given.
        fill = float('nan') if other is None else other
        return torch.where(mask, vals, torch.full_like(vals, fill))

    def store(ptr, val, mask):
        off, val, mask = torch.broadcast_tensors(
            torch.as_tensor(ptr.off), as_tensor(val, ptr.base), mask)
        assert off[mask].unique().numel() == int(mask.sum()), 'stored twice'
        ptr.base[off[mask]] = val[mask].to(ptr.base.dtype)

    def where(c, a, b):
        return torch.where(c, as_tensor(a, b), as_tensor(b, a))

    tl.program_id = lambda axis: state['pid'][axis]
    tl.num_programs = lambda axis: state['grid'][axis]
    tl.arange = torch.arange
    tl.cdiv = lambda a, b: -(-a // b)
    tl.static_range = builtins.range
    tl.range = lambda a, b, step=1, num_stages=None: builtins.range(a, b,
                                                                    step)
    tl.load, tl.store, tl.where = load, store, where
    tl.exp, tl.log, tl.abs = torch.exp, torch.log, torch.abs
    tl.floor = torch.floor
    tl.maximum = lambda a, b: torch.maximum(as_tensor(a, b), as_tensor(b, a))
    tl.minimum = lambda a, b: torch.minimum(as_tensor(a, b), as_tensor(b, a))
    tl.max = lambda v, axis: torch.amax(v, dim=axis)
    tl.sum = lambda v, axis: torch.sum(v, dim=axis)
    tl.cumsum = lambda v, axis: torch.cumsum(v, dim=axis)
    tl.expand_dims = lambda v, axis: v.unsqueeze(axis)
    tl.zeros_like = torch.zeros_like
    return tl, state


def _pointer(t):
    """A tensor's first element as a pointer into its whole storage, so
    a strided view is read where it lies."""
    flat = torch.empty(0, dtype=t.dtype).set_(
        t.untyped_storage(), 0, (t.untyped_storage().nbytes()
                                 // t.element_size(),))
    return _Ptr(flat, t.storage_offset())


class _Kernel:
    """``triton.jit``'s result: callable from a kernel, launched over a
    grid one program at a time."""

    def __init__(self, fn, state):
        self.fn, self.state = fn, state

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def __getitem__(self, grid):
        def launch(*args, num_warps=4, **constexprs):
            args = [_pointer(a) if isinstance(a, torch.Tensor) else a
                    for a in args]
            self.state['grid'] = grid
            for pid in itertools.product(*map(range, grid)):
                self.state['pid'] = pid
                self.fn(*args, **constexprs)
            return types.SimpleNamespace(n_regs=None, n_spills=None)
        return launch


@pytest.fixture
def standin(monkeypatch):
    """Triton replaced by the stand-in, and every kernel cache cleared
    before and after, so no stand-in kernel outlives the test."""
    tl, state = _language()
    triton = types.ModuleType('triton')
    triton.language = tl

    def jit(fn=None, **options):
        return _Kernel(fn, state) if fn else (lambda f: _Kernel(f, state))

    triton.jit = jit
    monkeypatch.setitem(sys.modules, 'triton', triton)
    monkeypatch.setitem(sys.modules, 'triton.language', tl)
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda device: types.SimpleNamespace(
                            multi_processor_count=2))
    for module in (fs, probe):
        for name in ('tl', '_softplus_tl', '_slope_tl', '_bins_sum',
                     'copy_tile'):
            if hasattr(module, name):
                monkeypatch.delattr(module, name)
    monkeypatch.setattr(fs, '_KERNELS', {})
    monkeypatch.setattr(probe, '_PROBE', {})
    monkeypatch.setattr(probe, '_ALIGNED', {})
    yield
    for module in (fs, probe):
        for name in ('tl', '_softplus_tl', '_slope_tl', '_bins_sum',
                     'copy_tile'):
            if hasattr(module, name):
                delattr(module, name)


def _k2(x, params, bounds, gy, gl, K, layout):
    consts = fs._constants(x.device, x.dtype, 1e-4, 1e-4)
    gx = torch.full_like(x, float('nan'))
    gp = torch.full_like(params, float('nan'))
    fs._backward_launch(x, params, bounds, consts, gy, gl, gx, gp, K, layout)
    return gx, gp


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
# As the card tests, less the bench shape: ragged tiles, K = 3 and 16,
# F = 97 and 13, one row; and K = 1, a single bin.
@pytest.mark.parametrize('shape', [(37, 13, 5), (65, 97, 3), (33, 13, 16),
                                   (1, 97, 8), (1, 13, 3), (9, 7, 1)])
@pytest.mark.parametrize('adversarial', [False, True])
def test_k2_source_matches_plain_version(standin, dtype, shape, adversarial):
    B, F, K = shape
    x, params, x0, xf, y0, yf, gy, gl = _inputs(B, F, K, dtype, 'cpu',
                                                adversarial)
    xi, pi = x.clone().requires_grad_(), params.clone().requires_grad_()
    plain = torch.autograd.grad(
        fs.fused_spline_reference(xi, pi, x0, xf, y0, yf, K), (xi, pi),
        (gy, gl))
    got = _k2(x, params, (x0, xf, y0, yf), gy, gl, K, fs.BACKWARD_LAYOUT)
    tol = TOLERANCES[dtype][1]
    for g, p in zip(got, plain):
        assert torch.isfinite(g).all()
        scale = max(1.0, float(p.abs().max()))
        assert float((g - p).abs().max()) <= tol * scale


@pytest.mark.parametrize('tile', ['2x64x4', '1x128x4', '8x32x8'])
def test_k2_source_agrees_across_tiles(standin, tile):
    x, params, x0, xf, y0, yf, gy, gl = _inputs(19, 97, 5, torch.float64,
                                                'cpu')
    bounds = (x0, xf, y0, yf)
    ref = _k2(x, params, bounds, gy, gl, 5, fs.BACKWARD_LAYOUT)
    got = _k2(x, params, bounds, gy, gl, 5, probe.parse_layout(tile))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize('tile', ['4x32x4', '2x16x1p2', '4x32x4ap3'])
def test_copy_probe_copies_k2s_inputs(standin, tile, monkeypatch):
    x, params, x0, xf, y0, yf, gy, gl = _inputs(37, 13, 5, torch.float64,
                                                'cpu')
    bounds = (x0, xf, y0, yf)
    outs = []
    empty_like = torch.empty_like
    monkeypatch.setattr(torch, 'empty_like',
                        lambda t: outs.append(empty_like(t)) or outs[-1])
    probe.launch_probe(x, params, bounds, gy, gl, 5, probe.parse_layout(tile))
    gx, gp = outs
    assert torch.equal(gp, params)
    torch.testing.assert_close(gx, x + gy + gl + x0 + xf + y0 + yf)
