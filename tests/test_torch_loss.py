"""Port of ``loss.py`` against the JAX package, float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfep_tpu.loss import BoltzmannKLDivLoss as JaxLoss
from tfep_tpu.loss import boltzmann_kl_div_loss as jax_loss
from tfep_tpu_torch.loss import BoltzmannKLDivLoss, boltzmann_kl_div_loss

from test_torch_common import ATOL, GRAD_ATOL, close, t

BATCH = 9


def _inputs(with_nan):
    rng = np.random.default_rng(0)
    target = rng.normal(size=BATCH)
    if with_nan:
        target[[2, 5]] = np.nan
    return dict(target_potentials=target, log_det_J=rng.normal(size=BATCH),
                log_weights=rng.normal(size=BATCH),
                ref_potentials=rng.normal(size=BATCH))


@pytest.mark.parametrize('ignore_nan', [False, True])
@pytest.mark.parametrize('optional', [(), ('log_det_J',),
                                      ('log_det_J', 'ref_potentials'),
                                      ('log_weights',),
                                      ('log_det_J', 'log_weights',
                                       'ref_potentials')])
def test_loss_variants(optional, ignore_nan):
    inputs = _inputs(with_nan=ignore_nan)
    keys = ('target_potentials',) + optional
    args_j = {k: jnp.asarray(inputs[k]) for k in keys}
    args_t = {k: t(inputs[k]).requires_grad_() for k in keys}
    loss_t = boltzmann_kl_div_loss(**args_t, ignore_nan=ignore_nan)
    close(loss_t, jax_loss(**args_j, ignore_nan=ignore_nan), ATOL)
    assert torch.isfinite(loss_t)

    loss_t.backward()
    grads_j = jax.grad(lambda a: jax_loss(**a, ignore_nan=ignore_nan))(args_j)
    for k in keys:
        # NaN entries have NaN or zero gradients on both sides alike.
        close(torch.nan_to_num(args_t[k].grad),
              np.nan_to_num(np.asarray(grads_j[k])), GRAD_ATOL)


def test_nan_propagates_without_ignore_nan():
    inputs = _inputs(with_nan=True)
    assert torch.isnan(boltzmann_kl_div_loss(t(inputs['target_potentials'])))


@pytest.mark.parametrize('ignore_nan', [False, True])
def test_module_wrapper(ignore_nan):
    inputs = _inputs(with_nan=ignore_nan)
    args_t = {k: t(v) for k, v in inputs.items()}
    args_j = {k: jnp.asarray(v) for k, v in inputs.items()}
    close(BoltzmannKLDivLoss(ignore_nan)(**args_t),
          JaxLoss(ignore_nan=ignore_nan)(**args_j), ATOL)
