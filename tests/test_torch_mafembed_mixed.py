"""The port's MAF embeddings (``nn/embeddings/mafembed.py``) and
``MixedTransformer`` against the JAX package's.

Mirrors the embedding and mixed-transformer tests of
``tests/nn/embeddings/test_embeddings.py`` and
``tests/nn/transformers/test_transformers.py``. In float64 on the CPU the
port's outputs, inverses and degrees must equal JAX's at ``ATOL`` and the
gradients at ``GRAD_ATOL``, with the JAX weights (perturbed) carried
across with no leaf missing or extra. A MAF with the map's periodic
embedding and a mixed transformer is held against JAX both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfep_tpu.nn.conditioners.made import generate_degrees
from tfep_tpu.nn.embeddings import (
    FlipInvariantEmbedding as JaxFlip, MixedEmbedding as JaxMixedEmb,
    PeriodicEmbedding as JaxPeriodic,
)
from tfep_tpu.nn.flows import MAF as JaxMAF
from tfep_tpu.nn.module import filter_value_and_grad
from tfep_tpu.nn.transformers import (
    AffineTransformer as JaxAffine, MixedTransformer as JaxMixed,
    NeuralSplineTransformer as JaxSpline,
)
from tfep_tpu_torch.convert import torch_name
from tfep_tpu_torch.nn.embeddings import (
    FlipInvariantEmbedding, MixedEmbedding, PeriodicEmbedding,
)
from tfep_tpu_torch.nn.flows import MAF
from tfep_tpu_torch.nn.transformers import (
    AffineTransformer, MixedTransformer, NeuralSplineTransformer,
)

from test_torch_common import (
    CPU, DTYPE, GRAD_ATOL, carry, close, jax_state, perturb, t,
    torch_generator,
)

BATCH = 5
ON_CPU = dict(device=CPU, dtype=DTYPE)


def inputs(n_features, seed=0, low=0.0, high=1.0):
    return np.random.default_rng(seed).uniform(low, high,
                                               size=(BATCH, n_features))


def check_module(module_j, module_t, x):
    """Forward and input gradient of an embedding, port against JAX."""
    # jit: JAX's eager dispatch compiles every operation apart.
    y_j = jax.jit(module_j.__call__)(jnp.asarray(x))
    grad_j = jax.jit(jax.grad(lambda z: jnp.sum(module_j(z) ** 3)))(
        jnp.asarray(x))
    xt = t(x).requires_grad_()
    y_t = module_t(xt)
    close(y_t, y_j)
    (grad_t,) = torch.autograd.grad(torch.sum(y_t ** 3), xt)
    close(grad_t, grad_j, GRAD_ATOL)
    return y_t


# =============================================================================
# Embeddings
# =============================================================================

@pytest.mark.parametrize('periodic', [None, [1, 4], [3, 0, 5]])
def test_periodic_embedding(periodic):
    limits = [-np.pi, np.pi]
    emb_j = JaxPeriodic.create(6, limits, periodic)
    emb_t = carry(emb_j, PeriodicEmbedding(6, limits, periodic, **ON_CPU))
    x = inputs(6, low=-3.0, high=3.0)
    y = check_module(emb_j, emb_t, x)
    n_periodic = 6 if periodic is None else len(periodic)
    assert y.shape == (BATCH, 6 + n_periodic)
    # One period apart, the same embedding.
    shifted = x.copy()
    shifted[:, emb_t.periodic_indices.numpy()] += 2 * np.pi
    close(emb_t(t(shifted)), y.detach())
    degrees = np.array([0, 1, 2, 3, 4, 5])
    np.testing.assert_array_equal(emb_t.get_degrees_out(degrees),
                                  emb_j.get_degrees_out(degrees))


def test_periodic_embedding_duplicates_raise():
    with pytest.raises(ValueError, match='duplicated'):
        PeriodicEmbedding(4, [0.0, 1.0], [1, 1], **ON_CPU)


def flip_pair(seed=0, n_features=9, embedded=(1, 2, 3, 4, 5, 6, 7, 8)):
    embedded = None if embedded is None else list(embedded)
    emb_j = perturb(JaxFlip.create(
        jax.random.key(seed), n_features, embedding_dimension=3,
        embedded_indices=embedded, vector_dimension=4,
        hidden_layer_width=6), seed=seed + 1)
    emb_t = FlipInvariantEmbedding(
        torch_generator(seed), n_features, embedding_dimension=3,
        embedded_indices=embedded, vector_dimension=4,
        hidden_layer_width=6, **ON_CPU)
    return emb_j, carry(emb_j, emb_t)


def test_flip_invariant_embedding():
    emb_j, emb_t = flip_pair()
    x = inputs(9, low=-1.0, high=1.0)
    y = check_module(emb_j, emb_t, x)
    assert y.shape == (BATCH, 1 + 2 * 3)
    # E(v) == E(-v) for each embedded vector.
    flipped = x.copy()
    flipped[:, 1:5] *= -1
    close(emb_t(t(flipped)), y.detach())
    degrees = np.array([0, 1, 1, 1, 1, 2, 2, 2, 2])
    np.testing.assert_array_equal(emb_t.get_degrees_out(degrees),
                                  emb_j.get_degrees_out(degrees))
    with pytest.raises(ValueError, match='same degree'):
        emb_t.get_degrees_out(np.arange(9))


def test_mixed_embedding():
    flip_j, flip_t = flip_pair(seed=2, n_features=4, embedded=None)
    per_j = JaxPeriodic.create(2, [0.0, 1.0])
    per_t = PeriodicEmbedding(2, [0.0, 1.0], **ON_CPU)
    indices = [[2, 3, 5, 6], [0, 7]]
    emb_j = JaxMixedEmb.create(9, [flip_j, per_j], indices)
    emb_t = carry(emb_j, MixedEmbedding(9, [flip_t, per_t], indices,
                                       device=CPU))
    y = check_module(emb_j, emb_t, inputs(9, seed=3))
    assert y.shape == (BATCH, 3 + 3 + 4)
    degrees = np.array([0, 1, 2, 2, 3, 2, 2, 4, 5])
    np.testing.assert_array_equal(emb_t.get_degrees_out(degrees),
                                  emb_j.get_degrees_out(degrees))
    with pytest.raises(ValueError, match='different feature indices'):
        MixedEmbedding(9, [per_t, per_t], [[0, 1], [1, 2]], device=CPU)
    with pytest.raises(ValueError, match='number of layers'):
        MixedEmbedding(9, [per_t], [[0, 1], [2, 3]], device=CPU)


# =============================================================================
# MixedTransformer
# =============================================================================

# Features 0-8; groups as MixedMAFMap gives them (distances, angles,
# torsions) plus an affine group, and feature 8 in no group.
GROUPS = [[0, 3, 6], [1, 4], [2, 5], [7]]


def mixed_pair(groups=GROUPS, n_features=9):
    lo, hi = np.full(3, 0.5), np.full(3, 2.0)
    zeros2, ones2 = np.zeros(2), np.ones(2)
    specs = [
        (dict(x0=lo, xf=hi, n_bins=4, identity_boundary_slopes=True,
              learn_upper_bound=True), {}),
        (dict(x0=zeros2, xf=ones2, n_bins=4), dict(fused='never')),
        (dict(x0=zeros2, xf=ones2, n_bins=4, circular=True), {}),
    ]
    jax_t = [JaxSpline.create(**kw, **extra) for kw, extra in specs]
    port_t = [NeuralSplineTransformer(**kw, **ON_CPU) for kw, _ in specs]
    jax_t.append(JaxAffine())
    port_t.append(AffineTransformer())
    mixed_j = JaxMixed.create(jax_t, groups)
    mixed_t = MixedTransformer(port_t, groups, n_features=n_features,
                               device=CPU)
    return mixed_j, carry(mixed_j, mixed_t)


def mixed_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.05, 0.95, size=(BATCH, 9))
    x[:, [0, 3, 6]] = rng.uniform(0.6, 1.9, size=(BATCH, 3))
    return x


def test_mixed_transformer():
    mixed_j, mixed_t = mixed_pair()
    n_params = len(mixed_j.get_identity_parameters(8))
    assert mixed_t.param_lengths == mixed_j.param_lengths
    np.testing.assert_array_equal(mixed_t.get_identity_parameters(8),
                                  mixed_j.get_identity_parameters(8))
    degrees = np.arange(9)
    np.testing.assert_array_equal(mixed_t.get_degrees_out(degrees),
                                  mixed_j.get_degrees_out(degrees))

    x = mixed_inputs()
    params = 0.3 * np.random.default_rng(1).normal(size=(BATCH, n_params))
    y_j, ldj_j = jax.jit(mixed_j.forward)(jnp.asarray(x),
                                          jnp.asarray(params))
    x_j, ildj_j = jax.jit(mixed_j.inverse)(y_j, jnp.asarray(params))

    def loss(fn, a, p, lib):
        y, ldj = fn(a, p)
        return lib.sum(y ** 2) + lib.sum(ldj)

    grads_j = jax.jit(jax.grad(
        lambda a, p: loss(mixed_j.forward, a, p, jnp), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(params))

    xt, pt = t(x).requires_grad_(), t(params).requires_grad_()
    y_t, ldj_t = mixed_t(xt, pt)
    close(y_t, y_j)
    close(ldj_t, ldj_j)
    # The feature in no group passes through unchanged.
    close(y_t[:, 8], x[:, 8], 0.0)
    grads_t = torch.autograd.grad(torch.sum(y_t ** 2) + torch.sum(ldj_t),
                                  (xt, pt))
    for a, b in zip(grads_t, grads_j):
        close(a, b, GRAD_ATOL)
    with torch.no_grad():
        x_t, ildj_t = mixed_t.inverse(y_t, pt)
    close(x_t, x_j)
    close(ildj_t, ildj_j)
    close(x_t, x, 1e-9)
    close(ildj_t + ldj_t.detach(), 0.0, 1e-9)


def test_mixed_transformer_errors():
    spline = NeuralSplineTransformer(0.0, 1.0, 4, **ON_CPU)
    with pytest.raises(ValueError, match='greater than 1'):
        MixedTransformer([spline], [[0]], device=CPU)
    with pytest.raises(ValueError, match='number of elements'):
        MixedTransformer([spline, spline], [[0]], device=CPU)
    _, mixed_t = mixed_pair()
    with pytest.raises(ValueError, match='built for 9 features'):
        mixed_t(t(np.zeros((2, 8))), t(np.zeros((2, 100))))


def test_maf_with_periodic_embedding_and_mixed_transformer():
    """One MAF layer as MixedMAFMap builds it (features 8 conditioning):
    the embedding lifts the torsions, the mixed transformer maps the rest;
    forward, inverse and parameter gradients against JAX."""
    degrees = generate_degrees(9, order='descending',
                               conditioning_indices=[8])
    emb_j = JaxPeriodic.create(9, [0.0, 1.0], [2, 5])
    emb_t = PeriodicEmbedding(9, [0.0, 1.0], [2, 5], **ON_CPU)
    groups = [[0, 3, 6], [1, 4], [2, 5], [7]]
    mixed_j, mixed_t = mixed_pair(groups, n_features=8)
    maf_j = perturb(JaxMAF.create(jax.random.key(4), degrees,
                                  transformer=mixed_j, embedding=emb_j),
                    seed=5, scale=0.05)
    maf_t = carry(maf_j, MAF.create(torch_generator(4), degrees,
                                    transformer=mixed_t, embedding=emb_t,
                                    **ON_CPU))
    x = mixed_inputs(2)
    y_j, ldj_j = jax.jit(maf_j.forward)(jnp.asarray(x))
    y_t, ldj_t = maf_t(t(x))
    close(y_t, y_j)
    close(ldj_t, ldj_j)
    with torch.no_grad():
        x_t, ildj_t = maf_t.inverse(y_t)
    close(x_t, jax.jit(maf_j.inverse)(y_j)[0])
    close(x_t, x, 1e-9)
    close(ildj_t + ldj_t.detach(), 0.0, 1e-9)

    def loss_j(f):
        y, ldj = f.forward(jnp.asarray(x))
        return jnp.sum(y ** 2) - jnp.sum(ldj)

    _, grads = jax.jit(filter_value_and_grad(loss_j))(maf_j)
    expected = {torch_name(k): v for k, v in jax_state(grads).items()}
    (torch.sum(y_t ** 2) - torch.sum(ldj_t)).backward()
    for name, param in maf_t.named_parameters():
        close(param.grad, expected[name], GRAD_ATOL)
