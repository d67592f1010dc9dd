"""The fused spline's plain version (the CPU side of kernels K1/K2) against
the JAX package's ``fused_spline``, whose Pallas kernels run in interpret
mode as ``tests/ops/test_pallas_spline.py`` runs them. The gradients come
from autograd of the plain version on one side and from the JAX custom VJP
(the backward kernel's hand-derived math) on the other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfep_tpu.ops.pallas.spline as jax_fs
from tfep_tpu_torch.ops import spline as fs

from test_torch_common import ATOL, DTYPE, GRAD_ATOL, close, t

B, F, K = 16, 8, 5
MIN_BIN, MIN_SLOPE = 1e-4, 1e-4


@pytest.fixture(autouse=True)
def interpret_mode():
    previous = jax_fs.INTERPRET
    jax_fs.INTERPRET = True
    yield
    jax_fs.INTERPRET = previous


def make_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-4, 4, (B, F))  # incl. out-of-domain
    params = 0.5 * rng.normal(size=(B, (3 * K + 1) * F))
    x0 = -3.0 - 0.5 * rng.random(F)
    xf = 3.0 + 0.5 * rng.random(F)
    y0 = -2.0 * np.ones(F)
    yf = 4.0 * np.ones(F)
    return x, params, x0, xf, y0, yf


def adversarial_inputs():
    """Ported from ``tests/ops/test_pallas_spline.py``: x in bin 0, a later
    bin at the height floor and huge slopes, where an unclamped
    bin-relative position drives the denominator through zero."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-2.95, -2.2, (B, F))
    params = np.zeros((B, (3 * K + 1) * F))
    params[:, 2 * K * F:] = 9.0
    params[:, (K + 3) * F:(K + 4) * F] = -30.0
    params += 0.1 * rng.normal(size=params.shape)
    bound = np.ones(F)
    return x, params, -3.0 * bound, 3.0 * bound, -3.0 * bound, 3.0 * bound


def jax_spline(x, params, x0, xf, y0, yf):
    return jax_fs.fused_spline(x, params, x0, xf, y0, yf, K, MIN_BIN,
                               MIN_SLOPE, 16)


def torch_spline(x, params, x0, xf, y0, yf):
    return fs.fused_spline(x, params, x0, xf, y0, yf, K, MIN_BIN, MIN_SLOPE)


def _grads(inputs, which):
    """(gx, gparams) of a scalar loss of (y, dl) on both sides."""
    x, params, *bounds = inputs

    def loss_j(x, p):
        y, dl = jax_spline(x, p, *map(jnp.asarray, bounds))
        return {'y': jnp.sum(jnp.sin(y)), 'dl': jnp.sum(jnp.cos(dl)),
                'both': jnp.sum(jnp.sin(y)) + jnp.sum(dl)}[which]

    g_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(params))
    x_t = t(x).requires_grad_()
    p_t = t(params).requires_grad_()
    y, dl = torch_spline(x_t, p_t, *map(t, bounds))
    loss = {'y': torch.sum(torch.sin(y)), 'dl': torch.sum(torch.cos(dl)),
            'both': torch.sum(torch.sin(y)) + torch.sum(dl)}[which]
    loss.backward()
    return (x_t.grad, p_t.grad), g_j


@pytest.mark.parametrize('seed', [0, 1])
def test_forward_per_element(seed):
    inputs = make_inputs(seed)
    y_j, dl_j = jax_spline(*map(jnp.asarray, inputs))
    y_t, dl_t = torch_spline(*map(t, inputs))
    assert y_t.shape == dl_t.shape == (B, F)
    close(y_t, y_j, ATOL)
    close(dl_t, dl_j, ATOL)


@pytest.mark.parametrize('which', ['y', 'dl', 'both'])
def test_gradients_match_custom_vjp(which):
    (gx_t, gp_t), (gx_j, gp_j) = _grads(make_inputs(2), which)
    close(gx_t, gx_j, GRAD_ATOL)
    close(gp_t, gp_j, GRAD_ATOL)


def test_adversarial_case_finite_and_matching():
    inputs = adversarial_inputs()
    y_t, dl_t = torch_spline(*map(t, inputs))
    assert torch.isfinite(y_t).all() and torch.isfinite(dl_t).all()
    y_j, dl_j = jax_spline(*map(jnp.asarray, inputs))
    close(y_t, y_j, ATOL)
    close(dl_t, dl_j, ATOL)
    (gx_t, gp_t), (gx_j, gp_j) = _grads(inputs, 'both')
    assert torch.isfinite(gx_t).all() and torch.isfinite(gp_t).all()
    # 1e-8 as the JAX package's own test of this case: the floor-height
    # bin puts gradients of order 1e4 through the chain.
    close(gx_t, gx_j, 1e-8)
    close(gp_t, gp_j, 1e-8)


def test_cpu_path_launches_no_kernel():
    fs.LAUNCHES.reset()
    torch_spline(*map(t, make_inputs(0)))
    assert (fs.LAUNCHES.forward, fs.LAUNCHES.backward) == (0, 0)


@pytest.mark.parametrize('change, error', [
    (lambda a: [a[0].float()] + a[1:], TypeError),
    (lambda a: [a[0].int()] + [p.int() for p in a[1:]], TypeError),
    (lambda a: [a[0], a[1][:, :-1]] + a[2:], ValueError),
    (lambda a: a[:2] + [a[2][:-1]] + a[3:], ValueError),
    (lambda a: [a[0].t().contiguous().t()] + a[1:], ValueError),
    (lambda a: [a[0].to('meta'), a[1].to('meta')]
     + [b.to('meta') for b in a[2:]], ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, error):
    args = change([t(a) for a in make_inputs(0)])
    with pytest.raises(error):
        torch_spline(*args)


def test_byte_bounds_at_bench_shape():
    # x, params, 4 bound rows, y, dl; and x, params, bounds, gy, gl, gx, gp.
    assert fs.forward_bytes(4096, 96, 8, 4) == 44_041_728
    assert fs.backward_bytes(4096, 96, 8, 4) == 84_936_192
