"""Port of ``nn/transformers/{sos,moebius,quatprod}.py`` against the JAX
package, float64 on the CPU. Each case of
``tests/nn/transformers/test_transformers.py`` that covers these
transformers runs through both packages on the same inputs (forward,
inverse, log-det-Jacobians and the gradients of both directions), then
asserts the JAX case's own property on the port; a MAF with each
transformer is held as a whole."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfep_tpu.nn.conditioners.made import generate_degrees as jax_degrees
from tfep_tpu.nn.flows import MAF as JaxMAF
from tfep_tpu.nn.module import filter_value_and_grad
from tfep_tpu.nn.transformers import (
    MoebiusTransformer as JaxMoebius,
    QuaternionProductTransformer as JaxQuat,
    SOSPolynomialTransformer as JaxSOS,
    SymmetrizedMoebiusTransformer as JaxSymMoebius,
)
from tfep_tpu.nn.transformers.quatprod import (
    quat_conjugate as jax_quat_conjugate, quat_product as jax_quat_product,
)
from tfep_tpu_torch.nn.flows import MAF
from tfep_tpu_torch.nn.transformers import (
    MoebiusTransformer, QuaternionProductTransformer,
    SOSPolynomialTransformer, SymmetrizedMoebiusTransformer,
)
from tfep_tpu_torch.nn.transformers.quatprod import (
    quat_conjugate, quat_normalize, quat_product,
)

from test_torch_common import (
    ATOL, CPU, DTYPE, GRAD_ATOL, carry, close, perturb, t, torch_generator,
)

BATCH = 5
N_FEATURES = 6


def key_normal(seed, shape):
    """``jax.random.normal(jax.random.key(seed), shape)`` as numpy: the JAX
    case's own inputs."""
    return np.asarray(jax.random.normal(jax.random.key(seed), shape))


def unit_quaternions(seed, batch=BATCH):
    q = key_normal(seed, (batch, 2, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(batch, 8)


def compare(tr_t, tr_j, x, params, atol=ATOL, grad_atol=GRAD_ATOL,
            nan_in_jax=False):
    """Forward and inverse of both packages on the same inputs, with the
    gradients of both directions; returns the port's ``(y, ldj)``.

    ``nan_in_jax``: where a parameter vector is zero, JAX's gradient of
    its norm is 0/0 = NaN and torch's ``vector_norm`` takes the
    subgradient 0. The port's gradients are then held finite everywhere
    and equal to JAX's wherever JAX's are finite."""
    x, params = np.asarray(x, np.float64), np.asarray(params, np.float64)
    y_t, ldj_t = tr_t(t(x), t(params))
    y_j, ldj_j = tr_j.forward(jnp.asarray(x), jnp.asarray(params))
    close(y_t, y_j, atol)
    close(ldj_t, ldj_j, atol)
    x_t, ildj_t = tr_t.inverse(t(y_j), t(params))
    x_j, ildj_j = tr_j.inverse(y_j, jnp.asarray(params))
    close(x_t, x_j, atol)
    close(ildj_t, ildj_j, atol)

    for direction in ('forward', 'inverse'):
        def loss_j(a, p):
            out, ldj = getattr(tr_j, direction)(a, p)
            return jnp.sum(jnp.sin(out)) + jnp.sum(ldj)

        a = x if direction == 'forward' else np.asarray(y_j)
        ga_j, gp_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(a),
                                                      jnp.asarray(params))
        a_t = t(a).requires_grad_()
        p_t = t(params).requires_grad_()
        out, ldj = getattr(tr_t, direction)(a_t, p_t)
        (torch.sum(torch.sin(out)) + torch.sum(ldj)).backward()
        for grad_t, grad_j in ((a_t.grad, ga_j), (p_t.grad, gp_j)):
            grad_j = np.asarray(grad_j)
            if nan_in_jax:
                assert torch.isfinite(grad_t).all()
                finite = np.isfinite(grad_j)
                grad_t, grad_j = grad_t[torch.from_numpy(finite)], \
                    grad_j[finite]
            close(grad_t, grad_j, grad_atol)
    return y_t.detach(), ldj_t.detach()


def roundtrip_check(tr_t, x, params, atol):
    y, ldj = tr_t(t(x), t(params))
    x_back, ldj_inv = tr_t.inverse(y, t(params))
    close(x_back, x, atol)
    close(ldj + ldj_inv, np.zeros(len(x)), atol)


def identity_check(tr_t, tr_j, x, atol=1e-6):
    ident = tr_t.get_identity_parameters(x.shape[1])
    np.testing.assert_array_equal(ident,
                                  tr_j.get_identity_parameters(x.shape[1]))
    params = np.broadcast_to(ident, (x.shape[0], len(ident)))
    y, ldj = tr_t(t(x), t(params))
    close(y, x, atol)
    close(ldj, np.zeros(len(x)), atol)


# =============================================================================
# SOS polynomial
# =============================================================================

def test_sos_polynomial():
    tr_t, tr_j = SOSPolynomialTransformer(3), JaxSOS.create(n_polynomials=3)
    assert tr_t.n_parameters_per_feature == tr_j.n_parameters_per_feature
    x = key_normal(0, (BATCH, N_FEATURES))
    params = 0.5 * key_normal(
        1, (BATCH, tr_t.n_parameters_per_feature * N_FEATURES))
    y, _ = compare(tr_t, tr_j, x, params)
    assert torch.isfinite(y).all()
    identity_check(tr_t, tr_j, x)
    np.testing.assert_array_equal(tr_t.get_degrees_out(np.arange(4)),
                                  tr_j.get_degrees_out(np.arange(4)))
    with pytest.raises(ValueError, match='strictly greater'):
        SOSPolynomialTransformer(1)


def test_sos_polynomial_reference_values():
    tr_t = SOSPolynomialTransformer(2)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 2))
    p = rng.normal(size=(3, tr_t.n_parameters_per_feature, 2))
    compare(tr_t, JaxSOS.create(n_polynomials=2), x, p.reshape(3, -1))
    a0, a10, a11, a20, a21 = p[:, 0], p[:, 1], p[:, 2], p[:, 3], p[:, 4]
    c1 = a10 ** 2 + a20 ** 2
    c2 = a10 * a11 + a20 * a21
    c3 = (a11 ** 2 + a21 ** 2) / 3.0
    y, ldj = tr_t(t(x), t(p.reshape(3, -1)))
    close(y, a0 + c1 * x + c2 * x ** 2 + c3 * x ** 3)
    close(ldj, np.sum(np.log(np.abs(c1 + 2 * c2 * x + 3 * c3 * x ** 2)),
                      axis=1))


def test_sos_affine_equivalence():
    tr_t = SOSPolynomialTransformer(3)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 3))
    p = np.zeros((4, tr_t.n_parameters_per_feature, 3))
    p[:, 0] = rng.normal(size=(4, 3))
    p[:, 1::2] = rng.normal(size=(4, 3, 3))
    compare(tr_t, JaxSOS.create(n_polynomials=3), x, p.reshape(4, -1))
    scale = np.sum(p[:, 1::2] ** 2, axis=1)
    y, ldj = tr_t(t(x), t(p.reshape(4, -1)))
    close(y, p[:, 0] + scale * x)
    close(ldj, np.sum(np.log(scale), axis=1))


def test_sos_polynomial_inverse_round_trip():
    tr_t = SOSPolynomialTransformer(3)
    x = key_normal(20, (64, N_FEATURES))
    params = key_normal(21, (64, tr_t.n_parameters_per_feature * N_FEATURES))
    compare(tr_t, JaxSOS.create(n_polynomials=3), x, params)
    roundtrip_check(tr_t, x, params, atol=1e-9)


def test_sos_polynomial_inverse_affine_branch():
    tr_t = SOSPolynomialTransformer(2)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(8, 3))
    p = np.zeros((8, tr_t.n_parameters_per_feature, 3))
    p[:, 0] = rng.normal(size=(8, 3))
    p[:, 1::2] = rng.normal(size=(8, 2, 3))
    compare(tr_t, JaxSOS.create(n_polynomials=2), x, p.reshape(8, -1))
    roundtrip_check(tr_t, x, p.reshape(8, -1), atol=1e-9)


def test_sos_polynomial_inverse_near_triple_root():
    """Cardano is ill-conditioned near the triple root; the Newton polish
    recovers the input to the JAX test's own tolerance, 1e-6, and the two
    packages' inverses agree to it."""
    tr_t, tr_j = SOSPolynomialTransformer(2), JaxSOS.create(n_polynomials=2)
    x0 = 0.7
    p = np.zeros((1, tr_t.n_parameters_per_feature, 1))
    p[:, 1], p[:, 2], p[:, 3], p[:, 4] = -x0, 1.0, -0.5 * x0, 0.5
    params = p.reshape(1, -1)
    x = np.array([[x0 + 1e-3]])
    y, _ = tr_t(t(x), t(params))
    close(y, tr_j.forward(jnp.asarray(x), jnp.asarray(params))[0])
    x_back, _ = tr_t.inverse(y, t(params))
    close(x_back, x, 1e-6)
    close(x_back, tr_j.inverse(jnp.asarray(y.numpy()),
                               jnp.asarray(params))[0], 1e-6)


def test_sos_polynomial_inverse_tiny_linear_terms_f32():
    tr_t, tr_j = SOSPolynomialTransformer(2), JaxSOS.create(n_polynomials=2)
    p = np.zeros((1, tr_t.n_parameters_per_feature, 3), np.float32)
    p[:, 1::2] = np.sqrt(0.5, dtype=np.float32)
    x = np.array([[0.3, -1.2, 2.0]], np.float32)
    for a_k1 in (1e-8, 1e-7, 1e-5, 1e-3):
        p[:, 2::2] = a_k1
        params = torch.tensor(p.reshape(1, -1))
        y, _ = tr_t(torch.tensor(x), params)
        x_back, ldj_inv = tr_t.inverse(y, params)
        assert not torch.isnan(x_back).any(), f'NaN at {a_k1}'
        close(x_back, x, 1e-5)
        assert torch.isfinite(ldj_inv).all()
        x_j, _ = tr_j.inverse(jnp.asarray(y.numpy()),
                              jnp.asarray(p.reshape(1, -1)))
        # float32 on both sides: a few float32 ulp of |x| <= 2.
        close(x_back, x_j, 1e-6)


# =============================================================================
# Moebius
# =============================================================================

def _norms(v, dim):
    return np.linalg.norm(np.asarray(v).reshape(len(v), -1, dim), axis=-1)


def test_moebius_transformer():
    dim = 3
    tr_t, tr_j = MoebiusTransformer(dimension=dim), JaxMoebius(dimension=dim)
    x = key_normal(0, (BATCH, 2 * dim))
    params = 0.5 * key_normal(1, (BATCH, 2 * dim))
    y, _ = compare(tr_t, tr_j, x, params)
    np.testing.assert_allclose(_norms(y, dim), _norms(x, dim), atol=1e-6)
    roundtrip_check(tr_t, x, params, atol=1e-6)
    identity_check(tr_t, tr_j, x)


def test_symmetrized_moebius_transformer():
    dim = 3
    tr_t = SymmetrizedMoebiusTransformer(dimension=dim)
    tr_j = JaxSymMoebius(dimension=dim)
    x = key_normal(0, (BATCH, 2 * dim))
    params = 0.5 * key_normal(1, (BATCH, 2 * dim))
    y, _ = compare(tr_t, tr_j, x, params)
    np.testing.assert_allclose(_norms(y, dim), _norms(x, dim), atol=1e-6)
    roundtrip_check(tr_t, x, params, atol=1e-6)
    ident = tr_t.get_identity_parameters(2 * dim)
    np.testing.assert_array_equal(ident, tr_j.get_identity_parameters(2 * dim))
    y_id, _ = tr_t(t(x), t(np.broadcast_to(ident, (BATCH, 2 * dim))))
    close(y_id, x, 1e-6)


def test_symmetrized_moebius_flip_equivariance():
    dim = 3
    tr_t = SymmetrizedMoebiusTransformer(dimension=dim)
    x = key_normal(2, (BATCH, 2 * dim))
    w = 0.4 * key_normal(3, (BATCH, 2 * dim))
    y, _ = compare(tr_t, JaxSymMoebius(dimension=dim), x, w)
    y_neg, _ = tr_t(t(-x), t(w))
    close(y, -y_neg.detach().numpy())


def test_moebius_zero_w_is_identity_per_vector():
    dim = 3
    tr_t = MoebiusTransformer(dimension=dim)
    x = key_normal(4, (BATCH, 2 * dim))
    w = 0.5 * key_normal(5, (BATCH, 2, dim))
    w[:, 0] = 0.0
    y, _ = compare(tr_t, JaxMoebius(dimension=dim), x, w.reshape(BATCH, -1),
                   nan_in_jax=True)
    close(y.numpy().reshape(BATCH, 2, dim)[:, 0],
          x.reshape(BATCH, 2, dim)[:, 0])


@pytest.mark.parametrize('dimension', [2, 3, 5])
@pytest.mark.parametrize('unit_sphere', [False, True])
def test_moebius_dimensions_and_unit_sphere(dimension, unit_sphere):
    tr_t = MoebiusTransformer(dimension=dimension, unit_sphere=unit_sphere)
    tr_j = JaxMoebius(dimension=dimension, unit_sphere=unit_sphere)
    x = key_normal(12, (BATCH, 2 * dimension))
    if unit_sphere:
        xv = x.reshape(BATCH, 2, dimension)
        x = (xv / np.linalg.norm(xv, axis=-1, keepdims=True)).reshape(
            BATCH, 2 * dimension)
    w = 0.4 * key_normal(13, (BATCH, 2 * dimension))
    y, _ = compare(tr_t, tr_j, x, w)
    np.testing.assert_allclose(_norms(y, dimension), _norms(x, dimension),
                               atol=1e-9)
    roundtrip_check(tr_t, x, w, atol=1e-8)


# =============================================================================
# Quaternion product
# =============================================================================

def test_quaternion_product_transformer():
    tr_t, tr_j = QuaternionProductTransformer(), JaxQuat()
    q = unit_quaternions(0)
    params = key_normal(1, (BATCH, 8))
    y, ldj = compare(tr_t, tr_j, q, params)
    assert torch.equal(ldj, torch.zeros(BATCH, dtype=DTYPE))
    np.testing.assert_allclose(_norms(y, 4), 1.0, atol=1e-6)
    roundtrip_check(tr_t, q, params, atol=1e-7)
    identity_check(tr_t, tr_j, q)
    with pytest.raises(ValueError, match='divisible by 4'):
        tr_t.get_identity_parameters(6)


def test_quaternion_product_flip_equivariance():
    tr_t = QuaternionProductTransformer()
    q = unit_quaternions(6)
    w = key_normal(7, (BATCH, 8))
    y, _ = compare(tr_t, JaxQuat(), q, w)
    y_neg, _ = tr_t(t(-q), t(w))
    close(y, -y_neg.numpy(), 1e-12)


def test_quaternion_helpers():
    rng = np.random.default_rng(8)
    p, q = rng.normal(size=(3, 4)), rng.normal(size=(1, 4))
    close(quat_product(t(p), t(q)), jax_quat_product(jnp.asarray(p),
                                                     jnp.asarray(q)))
    close(quat_conjugate(t(p)), jax_quat_conjugate(jnp.asarray(p)))
    close(torch.linalg.vector_norm(quat_normalize(t(p)), dim=-1),
          np.ones(3))


# =============================================================================
# A MAF with each transformer
# =============================================================================

ZOO = {
    'sos': (lambda: SOSPolynomialTransformer(2), lambda: JaxSOS.create(), 6, 1),
    'moebius': (lambda: MoebiusTransformer(), lambda: JaxMoebius(), 6, 3),
    'symmetrized_moebius': (lambda: SymmetrizedMoebiusTransformer(),
                            lambda: JaxSymMoebius(), 6, 3),
    'quaternion': (lambda: QuaternionProductTransformer(),
                   lambda: JaxQuat(), 8, 4),
}


@pytest.mark.parametrize('name', sorted(ZOO))
def test_maf_with_transformer(name):
    """The whole MAF (weights carried across): forward, the inverse, the
    round trip and the loss gradients of every conditioner weight. Vector
    transformers see each vector's features at one degree."""
    make_t, make_j, n, repeats = ZOO[name]
    degrees = jax_degrees(n, repeats=repeats)
    maf_j = perturb(JaxMAF.create(jax.random.key(0), degrees,
                                  transformer=make_j()), seed=1)
    maf_t = carry(maf_j, MAF.create(torch_generator(0), degrees,
                                    transformer=make_t(), device=CPU,
                                    dtype=DTYPE))
    x = np.random.default_rng(2).normal(size=(BATCH, n))
    if name == 'quaternion':
        x = unit_quaternions(3)
    y_t, ldj_t = maf_t(t(x))
    y_j, ldj_j = maf_j.forward(jnp.asarray(x))
    close(y_t, y_j)
    close(ldj_t, ldj_j)
    x_t, ildj_t = maf_t.inverse(t(y_j))
    x_j, ildj_j = maf_j.inverse(y_j)
    close(x_t, x_j, 1e-9)
    close(ildj_t, ildj_j, 1e-9)
    close(x_t, x, 1e-8)

    def loss_j(flow):
        y, ldj = flow.forward(jnp.asarray(x))
        return jnp.mean(0.5 * jnp.sum(y ** 2, axis=-1) - ldj)

    _, g = filter_value_and_grad(loss_j)(maf_j)
    y, ldj = maf_t(t(x))
    torch.mean(0.5 * torch.sum(y ** 2, dim=-1) - ldj).backward()
    for layer_t, layer_j in zip(maf_t.conditioner.layers,
                                g.conditioner.layers):
        close(layer_t.weight.grad, layer_j.weight, GRAD_ATOL)
        close(layer_t.bias.grad, layer_j.bias, GRAD_ATOL)
        close(layer_t.gain.grad, layer_j.gain, GRAD_ATOL)
