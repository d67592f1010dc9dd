"""Radial basis expansions of the port against ``tfep_tpu``, float64."""

import jax.numpy as jnp
import numpy as np
import pytest

from tfep_tpu.nn.embeddings import radial as jax_radial
from tfep_tpu_torch.nn.embeddings import radial

from test_torch_common import ATOL, CPU, DTYPE, carry, close, jax_state, \
    perturb, t

R_CUTOFF = 2.5


def _pair(cls_name, trainable_means, trainable_stds):
    kwargs = dict(trainable_means=trainable_means,
                  trainable_stds=trainable_stds)
    if cls_name == 'gaussian':
        j = jax_radial.GaussianBasisExpansion.from_range(
            n_gaussians=7, max_mean=2.0, min_mean=0.5, **kwargs)
        p = radial.GaussianBasisExpansion.from_range(
            n_gaussians=7, max_mean=2.0, min_mean=0.5, device=CPU,
            dtype=DTYPE, **kwargs)
    else:
        j = jax_radial.BehlerParrinelloRadialExpansion.from_range(
            r_cutoff=R_CUTOFF, n_gaussians=7, max_mean=R_CUTOFF, **kwargs)
        p = radial.BehlerParrinelloRadialExpansion.from_range(
            r_cutoff=R_CUTOFF, n_gaussians=7, max_mean=R_CUTOFF, device=CPU,
            dtype=DTYPE, **kwargs)
    return j, p


FLAGS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize('cls_name', ['gaussian', 'behler_parrinello'])
@pytest.mark.parametrize('trainable_means, trainable_stds', FLAGS)
def test_key_sets_match(cls_name, trainable_means, trainable_stds):
    j, p = _pair(cls_name, trainable_means, trainable_stds)
    names = {k.replace('[', '.').replace(']', '')[1:] for k in jax_state(j)}
    port = set(dict(p.named_parameters())) | set(dict(p.named_buffers()))
    assert names == port
    # The trainable slots are the parameters, size 0 when frozen.
    params = dict(p.named_parameters())
    assert params['means_param'].numel() == (7 if trainable_means else 0)
    assert params['log_gammas_param'].numel() == (7 if trainable_stds
                                                  else 0)


@pytest.mark.parametrize('cls_name', ['gaussian', 'behler_parrinello'])
@pytest.mark.parametrize('trainable_means, trainable_stds', FLAGS)
def test_expansion_matches_jax(cls_name, trainable_means, trainable_stds):
    j, p = _pair(cls_name, trainable_means, trainable_stds)
    j = perturb(j, seed=3)
    carry(j, p)
    # Distances below, across and beyond the cutoff.
    r = np.random.default_rng(0).uniform(0.0, 3.5, (5, 4, 4))
    close(p(t(r)), j(jnp.asarray(r)), ATOL)


def test_switching_function():
    r = np.linspace(0.0, 4.0, 41)
    for force in (True, False):
        close(radial.behler_parrinello_cosine_switching_function(
                  R_CUTOFF, t(r), force),
              jax_radial.behler_parrinello_cosine_switching_function(
                  R_CUTOFF, jnp.asarray(r), force), ATOL)


def test_equidistant_grid():
    for args in ((5, 2.0, 0.0, 3.0), (9, 6.0, 1.0, 0.5)):
        for a, b in zip(radial._equidistant_means_and_stds(*args),
                        jax_radial._equidistant_means_and_stds(*args)):
            np.testing.assert_array_equal(a, b)
