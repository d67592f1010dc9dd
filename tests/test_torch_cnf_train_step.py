"""The port's CNF training step against the JAX package's: the
``benchmarks/cnf_bench.py`` step (ContinuousFlow over EGNNDynamics,
one-probe Hutchinson trace, rk4, regularization, checkpointed steps, the
KL loss with 0.01 of the regularizer, AdamW) at a small size, float64 on
the CPU.

Three AdamW steps run on both sides from the same (perturbed) weights,
frames and probe (JAX draws it from the flow's stored key on every step;
the port is fed the same). JAX takes its XLA formulation; the port its
main path, ``pairwise='fused'``, whose kernels' plain versions run on the
CPU (K4 forward, the hand-derived K5 backward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tfep_tpu.nn.dynamics import EGNNDynamics as JaxEGNN
from tfep_tpu.nn.flows import ContinuousFlow as JaxCNF
from tfep_tpu.nn.module import apply_updates, filter_value_and_grad, partition
from tfep_tpu_torch.convert import load_jax_state, torch_name
from tfep_tpu_torch.nn.dynamics import EGNNDynamics
from tfep_tpu_torch.nn.flows import ContinuousFlow
from tfep_tpu_torch.ops import egnn as E

from test_torch_common import (
    ATOL, CPU, DTYPE, close, jax_state, perturb, t, torch_generator,
)

N_ATOMS, FEAT, LAYERS, ODE_STEPS, BATCH, N_STEPS = 8, 16, 2, 2, 6, 3
LR = WEIGHT_DECAY = 1e-4
CONFIG = dict(trace_estimator='hutchinson', solver='rk4', n_steps=ODE_STEPS,
              regularization=True, checkpoint=True)


def _dynamics_kwargs():
    return dict(node_types=np.arange(N_ATOMS) % 4, r_cutoff=6.0,
                time_feat_dim=16, node_feat_dim=FEAT, distance_feat_dim=FEAT,
                n_layers=LAYERS, initialize_identity=False)


def _loss(y, ldj, reg, lib):
    return (lib.mean(0.5 * lib.sum(y ** 2, -1) - ldj)
            + 0.01 * lib.mean(reg))


def test_three_adamw_steps_match_jax():
    frames = 0.5 * np.random.default_rng(1).normal(size=(BATCH, N_ATOMS * 3))
    flow_j = perturb(JaxCNF.create(JaxEGNN.create(
        jax.random.key(0), pairwise='xla', **_dynamics_kwargs()), **CONFIG),
        seed=3, scale=0.05)
    key = jax.random.wrap_key_data(flow_j.hutchinson_key)
    probe = np.asarray(jax.random.normal(key, (1, *frames.shape),
                                         dtype=jnp.float64))
    optimizer = optax.adamw(LR)
    opt_state = optimizer.init(partition(flow_j)[0])

    @jax.jit
    def step_j(flow, opt_state, x):
        def loss_fn(f):
            return _loss(*f.forward(x), jnp)

        loss, grads = filter_value_and_grad(loss_fn)(flow)
        updates, opt_state = optimizer.update(grads, opt_state,
                                              partition(flow)[0])
        return apply_updates(flow, updates), opt_state, loss

    flow_t = ContinuousFlow.create(EGNNDynamics.create(
        torch_generator(0), device=CPU, dtype=DTYPE, pairwise='fused',
        **_dynamics_kwargs()), device=CPU, **CONFIG)
    load_jax_state(flow_t, {k: v for k, v in jax_state(flow_j).items()
                            if k != '.hutchinson_key'})
    assert flow_t.n_parameters() == flow_j.n_parameters()
    opt = torch.optim.AdamW(flow_t.parameters(), lr=LR,
                            weight_decay=WEIGHT_DECAY, eps=1e-8,
                            betas=(0.9, 0.999))
    E.LAUNCHES.reset()
    for _ in range(N_STEPS):
        flow_j, opt_state, loss_j = step_j(flow_j, opt_state,
                                           jnp.asarray(frames))
        opt.zero_grad()
        loss_t = _loss(*flow_t.integrate(t(frames), t(probe)), torch)
        loss_t.backward()
        # The loss does not reach the last layer's feature update: optax
        # still decays its weights (zero gradient), torch.optim skips a
        # parameter whose gradient is None.
        for param in flow_t.parameters():
            if param.grad is None:
                param.grad = torch.zeros_like(param)
        opt.step()
        close(loss_t, loss_j, ATOL)
    # The CPU runs the kernels' plain versions, never a kernel.
    assert (E.LAUNCHES.k3, E.LAUNCHES.k4, E.LAUNCHES.k5) == (0, 0, 0)

    trained = {torch_name(k): v for k, v in jax_state(flow_j).items()}
    for name, param in flow_t.named_parameters():
        close(param, trained[name], ATOL)
