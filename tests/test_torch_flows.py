"""Port of ``nn/flows/{autoregressive,maf,sequential}.py`` against the JAX
package, float64 on the CPU: forward, the three inverse paths, gradients
and rematerialization, with weights carried across."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfep_tpu.nn.flows import MAF as JaxMAF
from tfep_tpu.nn.flows import SequentialFlow as JaxSequential
from tfep_tpu.nn.module import filter_value_and_grad
from tfep_tpu.nn.transformers import (
    AffineTransformer as JaxAffine,
    NeuralSplineTransformer as JaxSpline,
    VolumePreservingShiftTransformer as JaxShift,
)
from tfep_tpu_torch.nn.conditioners.made import MADE, generate_degrees
from tfep_tpu_torch.nn.flows import MAF, AutoregressiveFlow, SequentialFlow
from tfep_tpu_torch.nn.transformers import (
    AffineTransformer, NeuralSplineTransformer,
    VolumePreservingShiftTransformer,
)

from test_torch_common import (
    CPU, DTYPE, GRAD_ATOL, carry, close, perturb, t,
    torch_generator,
)

N = 7
BATCH = 5


def _transformers(name, n_t):
    """(port, JAX) transformer over ``n_t`` transformed features."""
    if name == 'affine':
        return AffineTransformer(), JaxAffine()
    if name == 'shift':
        return (VolumePreservingShiftTransformer(device=CPU, dtype=DTYPE),
                JaxShift())
    circular = name == 'spline_circular'
    x0, xf = -4.0 * np.ones(n_t), 4.0 * np.ones(n_t)
    return (NeuralSplineTransformer(x0, xf, 4, circular=circular,
                                    device=CPU, dtype=DTYPE),
            JaxSpline.create(jnp.asarray(x0), jnp.asarray(xf), 4,
                             circular=circular, fused='never'))


def _maf_pair(name, degrees, seed=0):
    n_t = int(np.sum(degrees != -1))
    tr_t, tr_j = _transformers(name, n_t)
    maf_j = perturb(JaxMAF.create(jax.random.key(seed), degrees,
                                  transformer=tr_j), seed=seed + 1)
    maf_t = MAF.create(torch_generator(seed), degrees, transformer=tr_t,
                       device=CPU, dtype=DTYPE)
    return maf_j, carry(maf_j, maf_t)


DEGREES = {
    'ascending': generate_degrees(N),
    'conditioning': generate_degrees(N, conditioning_indices=[1, 4]),
    'blocks': generate_degrees(N, repeats=3, order='descending'),
}
TRANSFORMERS = ['affine', 'shift', 'spline', 'spline_circular']


def _inputs(name, seed):
    rng = np.random.default_rng(seed)
    if name == 'spline_circular':
        return rng.uniform(-3.9, 3.9, (BATCH, N))
    return 2.0 * rng.normal(size=(BATCH, N))


@pytest.mark.parametrize('degrees', sorted(DEGREES))
@pytest.mark.parametrize('name', TRANSFORMERS)
def test_maf_forward_and_gradients(name, degrees):
    maf_j, maf_t = _maf_pair(name, DEGREES[degrees])
    assert maf_t.n_parameters() == maf_j.n_parameters()
    x = _inputs(name, 2)
    y_t, ldj_t = maf_t(t(x))
    y_j, ldj_j = jax.jit(lambda f, x: f.forward(x))(maf_j, jnp.asarray(x))
    close(y_t, y_j)
    close(ldj_t, ldj_j)

    def loss_j(flow):
        y, ldj = flow.forward(jnp.asarray(x))
        return jnp.mean(0.5 * jnp.sum(y ** 2, axis=-1) - ldj)

    _, g = jax.jit(filter_value_and_grad(loss_j))(maf_j)
    y, ldj = maf_t(t(x))
    torch.mean(0.5 * torch.sum(y ** 2, dim=-1) - ldj).backward()
    for layer_t, layer_j in zip(maf_t.conditioner.layers, g.conditioner.layers):
        close(layer_t.weight.grad, layer_j.weight, GRAD_ATOL)
        close(layer_t.bias.grad, layer_j.bias, GRAD_ATOL)
        close(layer_t.gain.grad, layer_j.gain, GRAD_ATOL)


def _inverse_paths(maf_t):
    """The flow's inverse on each path it can take, forced by clearing the
    tables the faster paths need."""
    groups, rows = maf_t.inverse_groups_t, maf_t.inverse_param_rows
    paths = {}
    if maf_t._can_fast_inverse:
        paths['fast'] = maf_t.inverse
    maf_row = _with_tables(maf_t, None, rows)
    if maf_row._can_row_restricted_inverse:
        paths['rows'] = maf_row.inverse
    paths['looped'] = _with_tables(maf_t, None, None).inverse
    assert (maf_t.inverse_groups_t, maf_t.inverse_param_rows) == (groups, rows)
    return paths


def _with_tables(maf_t, groups, rows):
    view = copy.copy(maf_t)
    view.inverse_groups_t, view.inverse_param_rows = groups, rows
    return view


@pytest.mark.parametrize('degrees', sorted(DEGREES))
@pytest.mark.parametrize('name', TRANSFORMERS)
def test_maf_inverse_paths(name, degrees):
    maf_j, maf_t = _maf_pair(name, DEGREES[degrees], seed=3)
    y = _inputs(name, 4)
    x_j, ldj_j = jax.jit(lambda y: maf_j.inverse(y))(jnp.asarray(y))
    paths = _inverse_paths(maf_t)
    # Affine and spline transformers slice, the shift transformer does not.
    assert ('fast' in paths) == (name != 'shift')
    assert 'rows' in paths
    for path, inverse in paths.items():
        x_t, ldj_t = inverse(t(y))
        # The inverse composes one conditioner pass per degree group.
        close(x_t, x_j, 1e-9)
        close(ldj_t, ldj_j, 1e-9)
    y_back, ldj_fwd = maf_t(x_t)
    close(y_back, y, 1e-8)
    close(ldj_fwd + ldj_t, np.zeros(BATCH), 1e-8)


def test_inverse_falls_back_without_identity_parameters():
    """A spline with x0 != y0 cannot express the identity, so the
    row-restricted path falls back to the looped one and still inverts."""
    x0, xf = -4.0 * np.ones(N), 4.0 * np.ones(N)
    spline = NeuralSplineTransformer(x0, xf, 4, y0=x0 / 2, yf=xf / 2,
                                     device=CPU, dtype=DTYPE)
    maf_t = MAF.create(torch_generator(7), generate_degrees(N),
                       transformer=spline, initialize_identity=False,
                       device=CPU, dtype=DTYPE)
    maf_rows = _with_tables(maf_t, None, maf_t.inverse_param_rows)
    assert maf_rows._can_row_restricted_inverse
    y = 1.5 * np.random.default_rng(8).normal(size=(BATCH, N))
    x, ldj = maf_rows.inverse(t(y))
    y_back, _ = maf_t(x)
    close(y_back, y, 1e-7)


def test_autoregressive_empty_group_dropped():
    degrees_in = np.array([0, 1, 3])
    made = MADE(torch_generator(11), degrees_in, np.tile(degrees_in, 2),
                hidden_layers=[8], device=CPU, dtype=DTYPE)
    flow = AutoregressiveFlow.create(3, [[0], [1], [], [2]], made,
                                     AffineTransformer(),
                                     initialize_identity=False, device=CPU)
    assert len(flow.inverse_groups_t) == 3
    y = np.random.default_rng(12).normal(size=(4, 3))
    x, ldj = flow.inverse(t(y))
    y_back, ldj_fwd = flow(x)
    close(y_back, y, 1e-8)
    close(ldj_fwd + ldj, np.zeros(4), 1e-8)


@pytest.mark.parametrize('name', ['affine', 'spline'])
def test_identity_initialization(name):
    tr_t, _ = _transformers(name, N)
    maf_t = MAF.create(torch_generator(), generate_degrees(N),
                       transformer=tr_t, device=CPU, dtype=DTYPE)
    x = _inputs(name, 9)
    y, ldj = maf_t(t(x))
    close(y, x, 1e-12)
    close(ldj, np.zeros(BATCH), 1e-12)


@pytest.mark.parametrize('remat', [False, True])
def test_sequential_flow(remat):
    pairs = [_maf_pair('spline', generate_degrees(
        N, order='ascending' if i % 2 == 0 else 'descending'), seed=20 + i)
        for i in range(2)]
    flow_j = JaxSequential.create(*[p[0] for p in pairs], remat=remat)
    flow_t = SequentialFlow.create(*[MAF.create(
        torch_generator(), generate_degrees(
            N, order='ascending' if i % 2 == 0 else 'descending'),
        transformer=_transformers('spline', N)[0], device=CPU, dtype=DTYPE)
        for i in range(2)], remat=remat, device=CPU)
    carry(flow_j, flow_t)
    assert len(flow_t) == 2 and flow_t[1] is flow_t.flows[1]
    assert flow_t.n_parameters() == flow_j.n_parameters()

    x = _inputs('spline', 10)
    y_t, ldj_t = flow_t(t(x))
    y_j, ldj_j = jax.jit(lambda x: flow_j.forward(x))(jnp.asarray(x))
    close(y_t, y_j)
    close(ldj_t, ldj_j)
    x_t, ildj_t = flow_t.inverse(y_t)
    x_j, ildj_j = jax.jit(lambda y: flow_j.inverse(y))(y_j)
    close(x_t, x_j, 1e-9)
    close(ildj_t, ildj_j, 1e-9)

    def loss_j(flow):
        y, ldj = flow.forward(jnp.asarray(x))
        return jnp.mean(0.5 * jnp.sum(y ** 2, axis=-1) - ldj)

    _, g = jax.jit(filter_value_and_grad(loss_j))(flow_j)
    y, ldj = flow_t(t(x))
    torch.mean(0.5 * torch.sum(y ** 2, dim=-1) - ldj).backward()
    for maf_t, maf_g in zip(flow_t.flows, g.flows):
        for layer_t, layer_j in zip(maf_t.conditioner.layers,
                                    maf_g.conditioner.layers):
            close(layer_t.weight.grad, layer_j.weight, GRAD_ATOL)
            close(layer_t.gain.grad, layer_j.gain, GRAD_ATOL)
