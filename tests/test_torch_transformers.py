"""Port of ``nn/transformers/{affine,spline}.py`` against the JAX package,
float64 on the CPU: forward, inverse, log-det-Jacobians and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfep_tpu.nn.transformers import (
    AffineTransformer as JaxAffine,
    NeuralSplineTransformer as JaxSpline,
    VolumePreservingShiftTransformer as JaxShift,
)
from tfep_tpu_torch.nn.transformers import (
    AffineTransformer, NeuralSplineTransformer,
    VolumePreservingShiftTransformer,
)
from tfep_tpu_torch.ops import spline as ops_spline

from test_torch_common import ATOL, CPU, DTYPE, GRAD_ATOL, close, t

BATCH, N = 6, 5


def _compare(tr_t, tr_j, x, params, atol=ATOL, inverse_atol=ATOL):
    """Forward, inverse and the gradients of both against the JAX side."""
    y_t, ldj_t = tr_t(t(x), t(params))
    y_j, ldj_j = tr_j.forward(jnp.asarray(x), jnp.asarray(params))
    close(y_t, y_j, atol)
    close(ldj_t, ldj_j, atol)
    x_t, ildj_t = tr_t.inverse(t(y_j), t(params))
    x_j, ildj_j = tr_j.inverse(y_j, jnp.asarray(params))
    close(x_t, x_j, inverse_atol)
    close(ildj_t, ildj_j, inverse_atol)

    def loss_j(x, p):
        y, ldj = tr_j.forward(x, p)
        return jnp.sum(jnp.sin(y)) + jnp.sum(ldj)

    gx_j, gp_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(params))
    x_in = t(x).requires_grad_()
    p_in = t(params).requires_grad_()
    y, ldj = tr_t(x_in, p_in)
    (torch.sum(torch.sin(y)) + torch.sum(ldj)).backward()
    close(x_in.grad, gx_j, GRAD_ATOL)
    close(p_in.grad, gp_j, GRAD_ATOL)


def test_affine():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BATCH, N))
    params = 0.5 * rng.normal(size=(BATCH, 2 * N))
    tr = AffineTransformer()
    _compare(tr, JaxAffine(), x, params)
    np.testing.assert_array_equal(tr.get_identity_parameters(N),
                                  JaxAffine().get_identity_parameters(N))
    np.testing.assert_array_equal(tr.get_degrees_out(np.arange(N)),
                                  JaxAffine().get_degrees_out(np.arange(N)))


@pytest.mark.parametrize('periodic', [False, True])
def test_volume_preserving_shift(periodic):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (BATCH, N))
    params = 0.7 * rng.normal(size=(BATCH, N))
    kwargs = {}
    if periodic:
        kwargs = dict(periodic_indices=np.array([1, 3]),
                      periodic_limits=np.array([-1.0, 1.0]))
    tr_t = VolumePreservingShiftTransformer(device=CPU, dtype=DTYPE, **kwargs)
    tr_j = JaxShift(**{k: jnp.asarray(v) for k, v in kwargs.items()})
    y_t, ldj_t = tr_t(t(x), t(params))
    y_j, ldj_j = tr_j.forward(jnp.asarray(x), jnp.asarray(params))
    close(y_t, y_j)
    close(ldj_t, ldj_j)
    x_t, _ = tr_t.inverse(y_t, t(params))
    close(x_t, tr_j.inverse(y_j, jnp.asarray(params))[0])
    close(x_t, x)


SPLINE_CONFIGS = {
    'standard': {},
    'other_output_domain': dict(y0=2.0, yf=6.0),
    'circular': dict(circular=True),
    'circular_identity_slopes': dict(circular=True,
                                     identity_boundary_slopes=True),
    'identity_slopes': dict(identity_boundary_slopes=True),
    'learn_upper': dict(learn_upper_bound=True),
    'learn_lower': dict(learn_lower_bound=True),
    'learn_both': dict(learn_lower_bound=True, learn_upper_bound=True),
    'learn_both_identity_slopes': dict(learn_lower_bound=True,
                                       learn_upper_bound=True,
                                       identity_boundary_slopes=True),
}


def _spline_pair(config, fused, n_bins=5):
    kwargs = dict(SPLINE_CONFIGS[config])
    x0, xf = -2.0 * np.ones(N), 2.0 * np.ones(N)
    for name in ('y0', 'yf'):
        if name in kwargs:
            kwargs[name] = kwargs[name] * np.ones(N)
    tr_t = NeuralSplineTransformer(x0, xf, n_bins, fused=fused, device=CPU,
                                   dtype=DTYPE, **kwargs)
    tr_j = JaxSpline.create(jnp.asarray(x0), jnp.asarray(xf), n_bins,
                            fused='never',
                            **{k: (jnp.asarray(v) if k in ('y0', 'yf')
                                   else v) for k, v in kwargs.items()})
    return tr_t, tr_j


@pytest.mark.parametrize('fused', ['auto', 'never'])
@pytest.mark.parametrize('config', sorted(SPLINE_CONFIGS))
def test_spline_options(config, fused):
    tr_t, tr_j = _spline_pair(config, fused)
    assert tr_t.n_parameters_per_feature == tr_j.n_parameters_per_feature
    rng = np.random.default_rng(2)
    circular = tr_t.circular
    # Inputs inside the domain for a circular spline, else partly outside.
    x = rng.uniform(-2.0, 2.0, (BATCH, N)) if circular else \
        rng.uniform(-3.0, 3.0, (BATCH, N))
    params = 0.5 * rng.normal(size=(BATCH, tr_t.n_parameters_per_feature * N))
    # The inverse solves a quadratic and carries its conditioning.
    _compare(tr_t, tr_j, x, params, inverse_atol=1e-9)
    np.testing.assert_array_equal(tr_t.get_degrees_out(np.arange(N)),
                                  tr_j.get_degrees_out(np.arange(N)))


@pytest.mark.parametrize('config', ['standard', 'circular', 'learn_both'])
def test_spline_identity_parameters(config):
    tr_t, tr_j = _spline_pair(config, 'auto')
    np.testing.assert_array_equal(tr_t.get_identity_parameters(N),
                                  tr_j.get_identity_parameters(N))
    x = np.random.default_rng(3).uniform(-2.0, 2.0, (BATCH, N))
    params = np.broadcast_to(tr_t.get_identity_parameters(N),
                             (BATCH, tr_t.n_parameters_per_feature * N))
    y, ldj = tr_t(t(x), t(params))
    # Zero parameters give the identity up to the min-bin floors' rounding.
    close(y, x, 1e-12)
    close(ldj, np.zeros(BATCH), 1e-12)


def test_spline_identity_needs_equal_domains():
    tr_t, _ = _spline_pair('other_output_domain', 'auto')
    with pytest.raises(ValueError, match='x0=y0'):
        tr_t.get_identity_parameters(N)


def test_spline_slice_features():
    rng = np.random.default_rng(4)
    x0 = -2.0 - rng.random(N)
    xf = 2.0 + rng.random(N)
    tr_t = NeuralSplineTransformer(x0, xf, 4, device=CPU, dtype=DTYPE)
    tr_j = JaxSpline.create(jnp.asarray(x0), jnp.asarray(xf), 4)
    idx = np.array([3, 0, 3])
    sub_t = tr_t.slice_features(torch.as_tensor(idx))
    sub_j = tr_j.slice_features(jnp.asarray(idx))
    close(sub_t.x0, sub_j.x0)
    close(sub_t.yf, sub_j.yf)
    close(tr_t.x0, x0)          # the original keeps its bounds
    y = rng.uniform(-3.0, 3.0, (BATCH, 3))
    params = 0.5 * rng.normal(size=(BATCH, 13 * 3))
    close(sub_t.inverse(t(y), t(params))[0],
          sub_j.inverse(jnp.asarray(y), jnp.asarray(params))[0], 1e-9)


def test_spline_scalar_bounds():
    tr_t = NeuralSplineTransformer(-2.0, 2.0, 4, device=CPU, dtype=DTYPE)
    tr_j = JaxSpline.create(-2.0, 2.0, 4, fused='never')
    rng = np.random.default_rng(5)
    x = rng.uniform(-3.0, 3.0, (BATCH, N))
    params = 0.5 * rng.normal(size=(BATCH, 13 * N))
    _compare(tr_t, tr_j, x, params, inverse_atol=1e-9)
    assert tr_t.slice_features(torch.as_tensor([1, 2])).x0.ndim == 0


def test_spline_dispatch(monkeypatch):
    """'auto' and 'always' take the fused spline in the standard
    configuration, 'never' and every other configuration do not."""
    calls = []
    real = ops_spline.fused_spline

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr('tfep_tpu_torch.nn.transformers.spline.fused_spline',
                        spy)
    x = np.zeros((2, N))
    for config, fused, expected in [
            ('standard', 'auto', True), ('standard', 'always', True),
            ('standard', 'never', False), ('circular', 'always', False),
            ('identity_slopes', 'auto', False),
            ('learn_upper', 'always', False)]:
        tr_t, _ = _spline_pair(config, fused)
        assert tr_t._fused_applicable == expected
        params = np.zeros((2, tr_t.n_parameters_per_feature * N))
        calls.clear()
        tr_t(t(x), t(params))
        assert bool(calls) == expected
    with pytest.raises(ValueError, match='fused'):
        NeuralSplineTransformer(-1.0, 1.0, 4, fused='sometimes', device=CPU)


def test_spline_remat_matches():
    tr_ref, _ = _spline_pair('circular', 'never')
    tr_remat, _ = _spline_pair('circular', 'never')
    tr_remat.remat = True
    rng = np.random.default_rng(6)
    x = rng.uniform(-2.0, 2.0, (BATCH, N))
    params = 0.5 * rng.normal(size=(BATCH, tr_ref.n_parameters_per_feature * N))
    grads = []
    for tr in (tr_ref, tr_remat):
        p = t(params).requires_grad_()
        y, ldj = tr(t(x), p)
        (torch.sum(y ** 2) + torch.sum(ldj)).backward()
        grads.append(p.grad)
    close(grads[1], grads[0].numpy(), 0.0)


@pytest.mark.parametrize('kwargs, match', [
    (dict(circular=True, learn_lower_bound=True), 'learnable'),
    (dict(circular=True, y0=-1.0), 'periodic'),
    (dict(min_bin_size=0.0), 'bin size'),
    (dict(min_slope=1.0), 'slope'),
])
def test_spline_rejects_bad_options(kwargs, match):
    with pytest.raises(ValueError, match=match):
        NeuralSplineTransformer(-2.0, 2.0, 4, device=CPU, **kwargs)
