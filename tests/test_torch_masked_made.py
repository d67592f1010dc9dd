"""Port of ``nn/masked.py`` and ``nn/conditioners/made.py`` against the
JAX package, float64 on the CPU, with weights carried across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfep_tpu.nn.conditioners.made import MADE as JaxMADE
from tfep_tpu.nn.conditioners.made import generate_degrees as jax_degrees
from tfep_tpu.nn.masked import MaskedLinear as JaxMaskedLinear
from tfep_tpu.nn.masked import create_autoregressive_mask as jax_mask
from tfep_tpu.nn.module import filter_value_and_grad
from tfep_tpu_torch.nn.conditioners.made import MADE, generate_degrees
from tfep_tpu_torch.nn.masked import MaskedLinear, create_autoregressive_mask

from test_torch_common import (
    CPU, DTYPE, GRAD_ATOL, carry, close, perturb, t, torch_generator,
)


@pytest.mark.parametrize('strictly_less', [False, True])
@pytest.mark.parametrize('transpose', [False, True])
def test_create_autoregressive_mask(strictly_less, transpose):
    rng = np.random.default_rng(0)
    d_in = rng.integers(-1, 4, 7)
    d_out = rng.integers(0, 4, 5)
    np.testing.assert_array_equal(
        create_autoregressive_mask(d_in, d_out, strictly_less, transpose),
        jax_mask(d_in, d_out, strictly_less, transpose))


def _layer_pair(connectivity, weight_norm, seed=0):
    """A JAX MaskedLinear (perturbed) and its port, same weights."""
    rng = np.random.default_rng(seed)
    d_in = np.array([0, 1, 2, 0, 1, 2, 1])
    d_out = np.array([0, 1, 2, 2, 1, 0, 1, 2])
    kwargs = {}
    if connectivity == 'mask':
        kwargs['mask'] = rng.random((8, 7)) < 0.6
    elif connectivity == 'degrees':
        kwargs.update(degrees_in=d_in, degrees_out=d_out, strictly_less=True)
    layer_j = perturb(JaxMaskedLinear.create(
        jax.random.key(seed), 7, 8, weight_norm=weight_norm, **kwargs),
        seed=seed + 1)
    layer_t = MaskedLinear(torch_generator(seed), 7, 8,
                           weight_norm=weight_norm, device=CPU, dtype=DTYPE,
                           **kwargs)
    return layer_j, carry(layer_j, layer_t)


@pytest.mark.parametrize('connectivity', ['dense', 'mask', 'degrees'])
@pytest.mark.parametrize('weight_norm', [False, True])
def test_masked_linear_forward_and_gradients(connectivity, weight_norm):
    layer_j, layer_t = _layer_pair(connectivity, weight_norm)
    x = np.random.default_rng(2).normal(size=(4, 7))
    close(layer_t(t(x)), layer_j(jnp.asarray(x)))
    assert layer_t.n_parameters() == layer_j.n_parameters()

    def loss_j(layer, x):
        return jnp.sum(jnp.sin(layer(x)))

    _, g_layer = filter_value_and_grad(loss_j)(layer_j, jnp.asarray(x))
    g_x = jax.grad(loss_j, argnums=1)(layer_j, jnp.asarray(x))
    x_t = t(x).requires_grad_()
    torch.sum(torch.sin(layer_t(x_t))).backward()
    close(x_t.grad, g_x, GRAD_ATOL)
    close(layer_t.weight.grad, g_layer.weight, GRAD_ATOL)
    close(layer_t.bias.grad, g_layer.bias, GRAD_ATOL)
    if weight_norm:
        close(layer_t.gain.grad, g_layer.gain, GRAD_ATOL)


def test_fully_masked_rows_stay_finite_under_autograd():
    """Output rows of degree 0 see no input under ``strictly_less``: their
    masked weight-norm row has norm 0, and the guard keeps the output and
    every gradient finite (and equal to the JAX package's)."""
    layer_j, layer_t = _layer_pair('degrees', weight_norm=True, seed=3)
    assert not layer_t._mask_array()[0].any()   # row 0 is fully masked
    x = np.random.default_rng(4).normal(size=(4, 7))
    y = layer_t(t(x))
    torch.sum(y ** 2).backward()
    for grad in (layer_t.weight.grad, layer_t.gain.grad, layer_t.bias.grad):
        assert torch.isfinite(grad).all()
    _, g = filter_value_and_grad(
        lambda l: jnp.sum(l(jnp.asarray(x)) ** 2))(layer_j)
    close(layer_t.weight.grad, g.weight, GRAD_ATOL)
    close(layer_t.gain.grad, g.gain, GRAD_ATOL)


@pytest.mark.parametrize('weight_norm', [False, True])
def test_set_output_and_restrict_rows(weight_norm):
    layer_j, layer_t = _layer_pair('degrees', weight_norm, seed=5)
    x = np.random.default_rng(6).normal(size=(3, 7))
    rows = np.array([5, 1, 1, 7])
    close(layer_t.restrict_rows(torch.as_tensor(rows))(t(x)),
          layer_j.restrict_rows(jnp.asarray(rows))(jnp.asarray(x)))

    out = np.arange(8.0)
    close(layer_t.set_output(out)(t(x)),
          layer_j.set_output(jnp.asarray(out))(jnp.asarray(x)))
    close(layer_t(t(x)), np.broadcast_to(out, (3, 8)))


@pytest.mark.parametrize('args, kwargs, expected', [
    ((3,), {}, [0, 1, 2]),
    ((7,), dict(order='descending', max_value=2), [2, 1, 0, 2, 1, 0, 2]),
    ((7,), dict(max_value=2, conditioning_indices=[0, 2, 3]),
     [-1, 0, -1, -1, 1, 2, 0]),
    ((6,), dict(repeats=2), [0, 0, 1, 1, 2, 2]),
    ((7,), dict(repeats=[1, 3, 2], conditioning_indices=[2]),
     [0, 1, -1, 1, 1, 2, 2]),
    ((9,), dict(order='random', seed=4), None),
])
def test_generate_degrees(args, kwargs, expected):
    degrees = generate_degrees(*args, **kwargs)
    np.testing.assert_array_equal(degrees, jax_degrees(*args, **kwargs))
    if expected is not None:
        assert degrees.tolist() == expected


def test_generate_degrees_rejects_bad_order():
    with pytest.raises(ValueError):
        generate_degrees(4, order='sideways')


HIDDEN_SPECS = {
    'count': 2,
    'widths': [9, 12],
    'degrees': [np.array([0, 1, 2, 0, 1, 2, -1, 0, 1]),
                np.array([2, 1, 0, 2, 1, 0, 1])],
}


def _made_pair(hidden, weight_norm=True, seed=0):
    degrees_in = generate_degrees(5, conditioning_indices=[2])
    degrees_out = np.tile(degrees_in[degrees_in != -1], 3)
    made_j = perturb(JaxMADE.create(
        jax.random.key(seed), degrees_in, degrees_out,
        hidden_layers=HIDDEN_SPECS[hidden], weight_norm=weight_norm),
        seed=seed + 1)
    made_t = MADE(torch_generator(seed), degrees_in, degrees_out,
                  hidden_layers=HIDDEN_SPECS[hidden],
                  weight_norm=weight_norm, device=CPU, dtype=DTYPE)
    return made_j, carry(made_j, made_t)


@pytest.mark.parametrize('hidden', sorted(HIDDEN_SPECS))
@pytest.mark.parametrize('weight_norm', [False, True])
def test_made_forward_and_rows(hidden, weight_norm):
    made_j, made_t = _made_pair(hidden, weight_norm)
    assert made_t.dimensions_hidden == made_j.dimensions_hidden
    assert made_t.dimension_out == made_j.dimension_out
    assert made_t.n_parameters() == made_j.n_parameters()
    x = np.random.default_rng(7).normal(size=(6, 5))
    close(made_t(t(x)), made_j(jnp.asarray(x)))
    rows = np.array([11, 0, 4, 4])
    close(made_t.forward_rows(t(x), torch.as_tensor(rows)),
          made_j.forward_rows(jnp.asarray(x), jnp.asarray(rows)))


def test_made_gradients_and_autoregressive_property():
    made_j, made_t = _made_pair('count')
    x = np.random.default_rng(8).normal(size=(6, 5))
    _, g = filter_value_and_grad(
        lambda m: jnp.sum(jnp.tanh(m(jnp.asarray(x)))))(made_j)
    torch.sum(torch.tanh(made_t(t(x)))).backward()
    for layer_t, layer_j in zip(made_t.layers, g.layers):
        close(layer_t.weight.grad, layer_j.weight, GRAD_ATOL)
        close(layer_t.gain.grad, layer_j.gain, GRAD_ATOL)
        close(layer_t.bias.grad, layer_j.bias, GRAD_ATOL)

    # Output j of degree d depends only on inputs of degree < d.
    jac = torch.autograd.functional.jacobian(
        lambda z: made_t(z[None])[0], t(x[0]))
    d_in = np.asarray(made_t.degrees_in_list)
    d_out = np.asarray(made_t.degrees_out_list)
    allowed = d_out[:, None] > d_in[None, :]
    assert torch.all(jac[torch.as_tensor(~allowed)] == 0)


def test_made_rejects_too_narrow_hidden_layer():
    with pytest.raises(ValueError, match='too small'):
        MADE(torch_generator(), np.arange(4), np.tile(np.arange(4), 2),
             hidden_layers=[2], device=CPU, dtype=DTYPE)
