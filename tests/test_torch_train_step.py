"""The port's main path against the JAX package's: the neural-spline MAF
training step of ``bench.py`` (``build_spline_maf_train_step``) at its
widths (96 DOFs, 6 MAF layers, 8 bins) and batch 32, float64 on the CPU.

Three AdamW steps run on both sides from the same (perturbed) weights and
the same frames. JAX takes its XLA spline path (``fused='never'``); the
port takes its main path, the fused spline, whose plain version runs on
the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tfep_tpu.nn.conditioners.made import generate_degrees
from tfep_tpu.nn.flows import MAF as JaxMAF
from tfep_tpu.nn.flows import SequentialFlow as JaxSequential
from tfep_tpu.nn.module import apply_updates, filter_value_and_grad, partition
from tfep_tpu.nn.transformers import NeuralSplineTransformer as JaxSpline
from tfep_tpu_torch.convert import torch_name
from tfep_tpu_torch.loss import boltzmann_kl_div_loss
from tfep_tpu_torch.nn.flows import MAF, SequentialFlow
from tfep_tpu_torch.nn.transformers import NeuralSplineTransformer
from tfep_tpu_torch.ops import spline as ops_spline

from test_torch_common import (
    ATOL, CPU, DTYPE, carry, close, jax_state, perturb, t, torch_generator,
)

N_DOFS, N_LAYERS, N_BINS, BATCH, N_STEPS = 96, 6, 8, 32, 3
LR = WEIGHT_DECAY = 1e-4


def _orders():
    return ['ascending' if i % 2 == 0 else 'descending'
            for i in range(N_LAYERS)]


def _jax_flow():
    keys = jax.random.split(jax.random.key(0), N_LAYERS)
    bound = np.ones(N_DOFS)
    layers = [JaxMAF.create(
        keys[i], generate_degrees(N_DOFS, order=order),
        transformer=JaxSpline.create(x0=-3.0 * jnp.asarray(bound),
                                     xf=3.0 * jnp.asarray(bound),
                                     n_bins=N_BINS, fused='never'))
        for i, order in enumerate(_orders())]
    # Perturbed: identity initialization zeroes every output gain.
    return perturb(JaxSequential.create(*layers), seed=1, scale=0.05)


def _torch_flow():
    generator = torch_generator(0)
    bound = np.ones(N_DOFS)
    return SequentialFlow.create(*[MAF.create(
        generator, generate_degrees(N_DOFS, order=order),
        transformer=NeuralSplineTransformer(-3.0 * bound, 3.0 * bound,
                                            N_BINS, device=CPU, dtype=DTYPE),
        device=CPU, dtype=DTYPE) for order in _orders()], device=CPU)


def test_three_adamw_steps_match_jax():
    frames = 1.5 * np.random.default_rng(2).normal(size=(BATCH, N_DOFS))

    flow_j = _jax_flow()
    optimizer = optax.adamw(LR)
    opt_state = optimizer.init(partition(flow_j)[0])

    @jax.jit
    def step_j(flow, opt_state, x):
        def loss_fn(f):
            y, ldj = f.forward(x)
            return jnp.mean(0.5 * jnp.sum(y ** 2, axis=-1) - ldj)

        loss, grads = filter_value_and_grad(loss_fn)(flow)
        updates, opt_state = optimizer.update(grads, opt_state,
                                              partition(flow)[0])
        return apply_updates(flow, updates), opt_state, loss

    flow_t = carry(flow_j, _torch_flow())
    assert flow_t.n_parameters() == flow_j.n_parameters()
    opt = torch.optim.AdamW(flow_t.parameters(), lr=LR,
                            weight_decay=WEIGHT_DECAY, eps=1e-8,
                            betas=(0.9, 0.999))
    ops_spline.LAUNCHES.reset()
    for _ in range(N_STEPS):
        flow_j, opt_state, loss_j = step_j(flow_j, opt_state,
                                           jnp.asarray(frames))
        opt.zero_grad()
        y, ldj = flow_t(t(frames))
        loss_t = boltzmann_kl_div_loss(0.5 * torch.sum(y ** 2, dim=-1), ldj)
        loss_t.backward()
        opt.step()
        close(loss_t, loss_j, ATOL)
    # The CPU runs the kernels' plain version, never a kernel.
    assert (ops_spline.LAUNCHES.forward, ops_spline.LAUNCHES.backward) == \
        (0, 0)

    named = dict(flow_t.named_parameters())
    trained = {torch_name(k): v for k, v in jax_state(flow_j).items()}
    assert set(named) <= set(trained)
    for name, param in named.items():
        close(param, trained[name], ATOL)
