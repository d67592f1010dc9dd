"""Kernels K1/K2 (``tfep_tpu_torch/ops/spline.py``) against their plain
version on a CUDA card. Marked ``gpu``: without a card every test skips.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_spline_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
"""

import pytest
import torch

from tfep_tpu_torch.ops import spline as fs

pytestmark = pytest.mark.gpu

# |kernel - plain| <= TOL * max(1, max|plain|). float32: Triton's exp, log
# and division are approximate (a few ulp) over some fifty dependent
# operations; float64: the same arithmetic in another order.
TOLERANCES = {torch.float32: (1e-4, 1e-3), torch.float64: (1e-12, 1e-10)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _inputs(B, F, K, dtype, device, adversarial=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    f64 = dict(generator=g, dtype=torch.float64)
    if adversarial:
        x = -2.95 + 0.75 * torch.rand(B, F, **f64)
        params = torch.zeros(B, (3 * K + 1) * F, dtype=torch.float64)
        params[:, 2 * K * F:] = 9.0
        params[:, (K + 3) * F:(K + 4) * F] = -30.0
        params += 0.1 * torch.randn(params.shape, **f64)
    else:
        x = -6.0 + 12.0 * torch.rand(B, F, **f64)
        params = 0.5 * torch.randn(B, (3 * K + 1) * F, **f64)
    x0 = -3.0 * torch.ones(F, dtype=torch.float64)
    xf = -x0
    # Keep x off the knots, where the gradient jumps between bins.
    knots = x0 + torch.cumsum(torch.softmax(
        params.reshape(B, 3 * K + 1, F)[:, :K], dim=1) * (6.0 - K * 1e-4)
        + 1e-4, dim=1)
    near = (x[:, None] - knots).abs().min(dim=1).values < 1e-4
    near |= (x - x0).abs() < 1e-4
    x = torch.where(near, x + 3e-4, x)
    gy = torch.randn(B, F, **f64)
    gl = torch.randn(B, F, **f64)
    return [t.to(dtype=dtype, device=device)
            for t in (x, params, x0, xf, x0, xf, gy, gl)]


def _check(actual, expected, tol):
    assert torch.isfinite(actual).all()
    scale = max(1.0, float(expected.abs().max()))
    assert float((actual - expected).abs().max()) <= tol * scale


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('shape', [(4096, 96, 8), (37, 13, 5)])
@pytest.mark.parametrize('adversarial', [False, True])
def test_kernels_match_plain_version(cuda, dtype, shape, adversarial):
    B, F, K = shape
    x, params, x0, xf, y0, yf, gy, gl = _inputs(B, F, K, dtype, cuda,
                                                adversarial)
    fwd_tol, bwd_tol = TOLERANCES[dtype]
    outs = {}
    for name, fn in (('kernel', fs.fused_spline),
                     ('plain', fs.fused_spline_reference)):
        xi = x.clone().requires_grad_()
        pi = params.clone().requires_grad_()
        y, dl = fn(xi, pi, x0, xf, y0, yf, K)
        gx, gp = torch.autograd.grad((y, dl), (xi, pi), (gy, gl))
        outs[name] = (y, dl, gx, gp)
    torch.cuda.synchronize()
    for i, (kern, plain) in enumerate(zip(outs['kernel'], outs['plain'])):
        _check(kern.detach(), plain.detach(), fwd_tol if i < 2 else bwd_tol)


def test_launch_counts(cuda):
    x, params, x0, xf, y0, yf, gy, gl = _inputs(64, 96, 8, torch.float32,
                                                cuda)
    fs.LAUNCHES.reset()
    y, dl = fs.fused_spline(x, params.requires_grad_(), x0, xf, y0, yf, 8)
    assert (fs.LAUNCHES.forward, fs.LAUNCHES.backward) == (1, 0)
    torch.autograd.grad((y, dl), params, (gy, gl))
    assert (fs.LAUNCHES.forward, fs.LAUNCHES.backward) == (1, 1)


def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, params, x0, xf, y0, yf, _, _ = _inputs(8, 16, 4, torch.float32, cuda)
    with pytest.raises(TypeError):
        fs.fused_spline(x.half(), params.half(), x0.half(), xf.half(),
                        y0.half(), yf.half(), 4)
    with pytest.raises(ValueError):
        fs.fused_spline(x.t().contiguous().t(), params, x0, xf, y0, yf, 4)
    with pytest.raises(TypeError):
        fs.fused_spline(x, params.cpu(), x0, xf, y0, yf, 4)
