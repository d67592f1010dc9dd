"""Mixed-precision products (``compute_dtype='bfloat16'``) of the port
against the JAX package, float32 storage on the CPU: ``MaskedLinear``,
``MADE``, ``MAF`` and ``EGNNDynamics`` on the dense path, forward and
gradients, and the product's rounding rule itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfep_tpu.nn.conditioners.made import MADE as JaxMADE
from tfep_tpu.nn.dynamics import EGNNDynamics as JaxEGNN
from tfep_tpu.nn.flows import MAF as JaxMAF
from tfep_tpu.nn.masked import MaskedLinear as JaxMaskedLinear
from tfep_tpu.nn.module import combine, filter_value_and_grad, partition
from tfep_tpu_torch.nn.conditioners.made import MADE, generate_degrees
from tfep_tpu_torch.nn.dynamics import EGNNDynamics
from tfep_tpu_torch.nn.flows import MAF
from tfep_tpu_torch.nn.masked import (
    MaskedLinear, low_precision_matmul, resolve_compute_dtype,
)

from test_torch_common import CPU, carry, perturb, torch_generator

F32 = torch.float32
BF16 = 'bfloat16'
# The forward is the float32 product of the same rounded operands in both
# packages; they sum in another order, a few float32 ulp apart.
FORWARD_RTOL = 1e-5
# Each gradient of a rounded operand is a float32 sum rounded once to
# bfloat16. Where the two packages' float32 sums straddle a bfloat16
# rounding boundary, the gradients differ by one bfloat16 ulp (2**-8 of
# the value's binade, at most 2**-7 of the value): the tolerance for those
# elements. Every other element agrees to float32 order.
BF16_ULP = 2.0 ** -7


def f32(module):
    """A JAX module's floating-point leaves in float32 (``perturb`` adds
    float64 noise under x64)."""
    trainable, frozen = partition(module)
    trainable = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                       trainable)
    return combine(trainable, frozen)


def tf(a):
    return torch.tensor(np.asarray(a), dtype=F32)


def assert_forward_close(actual, expected):
    actual = actual.detach().numpy() if isinstance(actual, torch.Tensor) \
        else np.asarray(actual)
    expected = np.asarray(expected)
    scale = max(1.0, float(np.abs(expected).max()))
    np.testing.assert_allclose(actual, expected, rtol=0,
                               atol=FORWARD_RTOL * scale)


def assert_grad_close(actual, expected, max_ulp_share=0.05):
    """Every element within one bfloat16 ulp, and all but a few within
    float32 order."""
    actual = actual.detach().numpy() if isinstance(actual, torch.Tensor) \
        else np.asarray(actual)
    expected = np.asarray(expected, dtype=np.float32)
    diff = np.abs(actual - expected)
    f32_order = FORWARD_RTOL * max(1.0, float(np.abs(expected).max()))
    assert np.all(diff <= BF16_ULP * np.abs(expected) + f32_order)
    assert np.mean(diff > f32_order) <= max_ulp_share


def _layer_pair(weight_norm, seed=0):
    kwargs = dict(degrees_in=np.array([0, 1, 2, 0, 1, 2, 1]),
                  degrees_out=np.array([0, 1, 2, 2, 1, 0, 1, 2]),
                  strictly_less=False)
    layer_j = f32(perturb(JaxMaskedLinear.create(
        jax.random.key(seed), 7, 8, weight_norm=weight_norm,
        dtype=jnp.float32, compute_dtype=BF16, **kwargs), seed=seed + 1))
    layer_t = MaskedLinear(torch_generator(seed), 7, 8,
                           weight_norm=weight_norm, device=CPU, dtype=F32,
                           compute_dtype=BF16, **kwargs)
    return layer_j, carry(layer_j, layer_t)


@pytest.mark.parametrize('weight_norm', [False, True])
def test_masked_linear_matches_jax(weight_norm):
    layer_j, layer_t = _layer_pair(weight_norm)
    x = np.random.default_rng(2).normal(size=(16, 7)).astype(np.float32)
    y_t = layer_t(tf(x))
    assert y_t.dtype == F32
    assert_forward_close(y_t, layer_j(jnp.asarray(x)))

    def loss_j(layer, x):
        return jnp.sum(jnp.sin(layer(x)))

    _, g_layer = filter_value_and_grad(loss_j)(layer_j, jnp.asarray(x))
    g_x = jax.grad(loss_j, argnums=1)(layer_j, jnp.asarray(x))
    x_t = tf(x).requires_grad_()
    torch.sum(torch.sin(layer_t(x_t))).backward()
    assert_grad_close(x_t.grad, g_x)
    assert_grad_close(layer_t.weight.grad, g_layer.weight)
    assert_grad_close(layer_t.bias.grad, g_layer.bias)
    if weight_norm:
        assert_grad_close(layer_t.gain.grad, g_layer.gain)


def test_product_rounds_as_jax_does():
    """The rule itself, on exact inputs: the forward is the float32
    product of the rounded operands; each operand's cotangent is the
    float32 product of the float32 cotangent with the other rounded
    operand, rounded once to bfloat16."""
    rng = np.random.default_rng(5)
    x, w = (tf(rng.normal(size=s)) for s in ((6, 9), (4, 9)))
    g = tf(rng.normal(size=(6, 4)))
    bf = torch.bfloat16
    xr, wr = x.to(bf).float(), w.to(bf).float()
    xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = low_precision_matmul(xt, wt, BF16)
    torch.testing.assert_close(y, xr @ wr.T, rtol=0, atol=0)
    y.backward(g)
    torch.testing.assert_close(xt.grad, (g @ wr).to(bf).float(), rtol=0,
                               atol=0)
    torch.testing.assert_close(wt.grad, (g.T @ xr).to(bf).float(), rtol=0,
                               atol=0)

    def jax_product(x, w):
        return jax.lax.dot_general(
            x.astype(jnp.bfloat16), w.astype(jnp.bfloat16).T,
            (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)

    _, vjp = jax.vjp(jax_product, jnp.asarray(x.numpy()),
                     jnp.asarray(w.numpy()))
    gx_j, gw_j = vjp(jnp.asarray(g.numpy()))
    assert_grad_close(xt.grad, gx_j)
    assert_grad_close(wt.grad, gw_j)


def test_product_composes_with_torch_func():
    """``jvp`` rounds tangents like operands; ``vmap(grad)`` of the
    product equals the per-slice gradients."""
    rng = np.random.default_rng(6)
    x, dx = tf(rng.normal(size=(5, 7))), tf(rng.normal(size=(5, 7)))
    ws = tf(rng.normal(size=(3, 4, 7)))
    bf = torch.bfloat16
    _, tangent = torch.func.jvp(lambda z: low_precision_matmul(z, ws[0], BF16),
                                (x,), (dx,))
    torch.testing.assert_close(tangent, dx.to(bf).float()
                               @ ws[0].to(bf).float().T, rtol=0, atol=0)

    def loss(w):
        return torch.sum(torch.sin(low_precision_matmul(x, w, BF16)))

    batched = torch.func.vmap(torch.func.grad(loss))(ws)
    for k in range(3):
        torch.testing.assert_close(batched[k], torch.func.grad(loss)(ws[k]),
                                   rtol=0, atol=0)


def test_made_matches_jax():
    degrees = generate_degrees(6)
    degrees_out = np.tile(degrees, 2)
    made_j = f32(perturb(JaxMADE.create(
        jax.random.key(0), degrees_in=degrees, degrees_out=degrees_out,
        hidden_layers=2, dtype=jnp.float32, compute_dtype=BF16), seed=1))
    made_t = carry(made_j, MADE(torch_generator(0), degrees_in=degrees,
                                degrees_out=degrees_out, hidden_layers=2,
                                device=CPU, dtype=F32, compute_dtype=BF16))
    x = np.random.default_rng(3).normal(size=(8, 6)).astype(np.float32)
    assert_forward_close(made_t(tf(x)), made_j(jnp.asarray(x)))

    def loss_j(made):
        return jnp.sum(jnp.tanh(made(jnp.asarray(x))))

    _, g = filter_value_and_grad(loss_j)(made_j)
    torch.sum(torch.tanh(made_t(tf(x)))).backward()
    for layer_t, layer_j in zip(made_t.layers, g.layers):
        assert_grad_close(layer_t.weight.grad, layer_j.weight)
        assert_grad_close(layer_t.bias.grad, layer_j.bias)
        assert_grad_close(layer_t.gain.grad, layer_j.gain)


def _maf_pair(compute_dtype):
    degrees = generate_degrees(6)
    maf_j = f32(perturb(JaxMAF.create(jax.random.key(0), degrees,
                                      dtype=jnp.float32,
                                      compute_dtype=compute_dtype), seed=1))
    maf_t = MAF.create(torch_generator(0), degrees, device=CPU, dtype=F32,
                       compute_dtype=compute_dtype)
    return maf_j, carry(maf_j, maf_t)


def test_maf_mixed_precision_compute():
    """``tests/nn/flows/test_maf.py::test_maf_mixed_precision_compute``
    on the port, and against the JAX flow: the bfloat16 flow stays
    invertible and close to float32, and equals JAX's bfloat16 flow."""
    maf32_j, maf32_t = _maf_pair(None)
    maf16_j, maf16_t = _maf_pair(BF16)
    x = np.random.default_rng(2).normal(size=(8, 6)).astype(np.float32)
    y32, _ = maf32_t(tf(x))
    y16, ldj16 = maf16_t(tf(x))
    assert y16.dtype == F32
    np.testing.assert_allclose(y16.detach().numpy(), y32.detach().numpy(),
                               atol=0.05, rtol=0.05)
    x_back, ldj_inv = maf16_t.inverse(y16)
    np.testing.assert_allclose(x_back.detach().numpy(), x, atol=1e-5)
    np.testing.assert_allclose((ldj16 + ldj_inv).detach().numpy(), 0.0,
                               atol=1e-5)

    y_j, ldj_j = maf16_j.forward(jnp.asarray(x))
    assert_forward_close(y16, y_j)
    assert_forward_close(ldj16, ldj_j)

    def loss_j(flow):
        y, ldj = flow.forward(jnp.asarray(x))
        return jnp.mean(0.5 * jnp.sum(y ** 2, axis=-1) - ldj)

    _, g = filter_value_and_grad(loss_j)(maf16_j)
    y, ldj = maf16_t(tf(x))
    torch.mean(0.5 * torch.sum(y ** 2, dim=-1) - ldj).backward()
    for layer_t, layer_j in zip(maf16_t.conditioner.layers,
                                g.conditioner.layers):
        assert_grad_close(layer_t.weight.grad, layer_j.weight)
        assert_grad_close(layer_t.bias.grad, layer_j.bias)
        assert_grad_close(layer_t.gain.grad, layer_j.gain)


N, FEAT, DFEAT, TFEAT, LAYERS, R_CUTOFF = 6, 8, 10, 4, 2, 3.0


def _egnn_pair():
    node_types = np.arange(N) % 3
    kwargs = dict(node_types=node_types, r_cutoff=R_CUTOFF,
                  time_feat_dim=TFEAT, node_feat_dim=FEAT,
                  distance_feat_dim=DFEAT, n_layers=LAYERS,
                  initialize_identity=False, compute_dtype=BF16)
    j = f32(perturb(JaxEGNN.create(jax.random.key(9), dtype=jnp.float32,
                                   **kwargs), seed=1))
    p = EGNNDynamics.create(torch_generator(0), device=CPU, dtype=F32,
                            **kwargs)
    return j, carry(j, p)


def test_egnn_dynamics_dense_matches_jax():
    j, p = _egnn_pair()
    rng = np.random.default_rng(0)
    x = (1.5 * rng.normal(size=(3, N * 3))).astype(np.float32)
    vel_t = p(0.3, tf(x))
    assert vel_t.dtype == F32
    assert_forward_close(vel_t, j(0.3, jnp.asarray(x)))

    def loss_j(dyn):
        return jnp.sum(jnp.sin(dyn(0.3, jnp.asarray(x))))

    _, g = filter_value_and_grad(loss_j)(j)
    torch.sum(torch.sin(p(0.3, tf(x)))).backward()
    layer_t, layer_j = p.graph_layers[0], g.graph_layers[0]
    for mlp in ('message_mlp', 'attention_mlp', 'update_x_mlp',
                'update_h_mlp'):
        for lt, lj in zip(getattr(layer_t, mlp).layers,
                          getattr(layer_j, mlp).layers):
            assert_grad_close(lt.weight.grad, lj.weight, max_ulp_share=0.1)


def test_egnn_forward_and_jvp_dense_matches_jax():
    """The CNF's dual pass on the dense path: tangents are rounded like
    the operands (``jax.jvp`` of the casts and the product)."""
    j, p = _egnn_pair()
    rng = np.random.default_rng(1)
    x = (1.5 * rng.normal(size=(3, N * 3))).astype(np.float32)
    v = rng.normal(size=(3, N * 3)).astype(np.float32)
    vel_j, jv_j = jax.jvp(lambda z: j(0.7, z), (jnp.asarray(x),),
                          (jnp.asarray(v),))
    vel_t, jv_t = p.forward_and_jvp(0.7, tf(x), tf(v))
    assert_forward_close(vel_t, vel_j)
    assert_grad_close(jv_t, jv_j, max_ulp_share=0.1)


def test_egnn_fused_rejects_compute_dtype():
    with pytest.raises(ValueError, match='compute_dtype'):
        EGNNDynamics.create(torch_generator(0), [0, 1], 3.0, device=CPU,
                            pairwise='fused', compute_dtype=BF16)


def test_compute_dtype_names():
    assert resolve_compute_dtype('bfloat16') is torch.bfloat16
    assert resolve_compute_dtype(torch.float16) is torch.float16
    assert resolve_compute_dtype(None) is None
    with pytest.raises(ValueError, match='compute_dtype'):
        resolve_compute_dtype('bf16')
