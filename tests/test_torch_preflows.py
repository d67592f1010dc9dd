"""The port's pre-flows (``PartialFlow``, ``CenteredCentroidFlow``,
``OrientedFlow``, ``PCAWhitenedFlow``) against the JAX package's.

Mirrors ``tests/nn/flows/test_preflows.py`` (and the ``PartialFlow`` test
of ``tests/nn/flows/test_maf.py``). Each flow is built on both sides
around a perturbed MAF whose weights are carried across; in float64 on the
CPU the port must give JAX's outputs, log-dets and inverse at ``ATOL`` and
its parameter gradients at ``GRAD_ATOL``, satisfy the constraints and raise
on the error paths that the JAX tests assert, match its own brute-force
log-det oracle, and leave the caller's input unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfep_tpu.nn.conditioners.made import generate_degrees
from tfep_tpu.nn.flows import CenteredCentroidFlow as JaxCentroid
from tfep_tpu.nn.flows import MAF as JaxMAF
from tfep_tpu.nn.flows import OrientedFlow as JaxOriented
from tfep_tpu.nn.flows import PartialFlow as JaxPartial
from tfep_tpu.nn.flows import PCAWhitenedFlow as JaxPCA
from tfep_tpu.nn.module import filter_value_and_grad
from tfep_tpu_torch.convert import torch_name
from tfep_tpu_torch.nn.flows import (
    MAF, CenteredCentroidFlow, Flow, OrientedFlow, PartialFlow,
    PCAWhitenedFlow,
)
from tfep_tpu_torch.utils.math import batch_log_abs_det_J

from test_torch_common import (
    ATOL, CPU, DTYPE, GRAD_ATOL, carry, close, jax_state, perturb, t,
    torch_generator,
)

BATCH = 4
N_POINTS = 5
N_DOFS = N_POINTS * 3
ON_CPU = dict(device=CPU, dtype=DTYPE)


def inner_pair(n_features, seed=0, perturbed=True):
    """A MAF on both sides; the JAX one perturbed unless ``perturbed`` is
    False (identity), the port's carrying its weights."""
    degrees = generate_degrees(n_features)
    maf_j = JaxMAF.create(jax.random.key(seed), degrees)
    if perturbed:
        maf_j = perturb(maf_j, seed=seed + 100)
    maf_t = MAF.create(torch_generator(seed), degrees, **ON_CPU)
    return maf_j, carry(maf_j, maf_t)


def frames(seed, n_features=N_DOFS, batch=BATCH):
    return np.random.default_rng(seed).normal(size=(batch, n_features))


def check_against_jax(flow_j, flow_t, x, inverse=True):
    """Forward, inverse and gradients of the port against JAX, the
    caller's tensors unchanged; returns the port's ``(y, log_det_J)``."""
    flow_t = carry(flow_j, flow_t)
    x_t = t(x)
    y_t, ldj_t = flow_t(x_t)
    y_j, ldj_j = flow_j.forward(jnp.asarray(x))
    close(x_t, x, atol=0.0)
    close(y_t, y_j)
    close(ldj_t, ldj_j)
    if inverse:
        y_in = y_t.detach().clone()
        x_back, ldj_inv = flow_t.inverse(y_in)
        x_back_j, ldj_inv_j = flow_j.inverse(y_j)
        close(y_in, y_t.detach(), atol=0.0)
        close(x_back, x_back_j)
        close(ldj_inv, ldj_inv_j)

    def loss_j(flow):
        y, ldj = flow.forward(jnp.asarray(x))
        return jnp.mean(0.5 * jnp.sum(y ** 2, axis=-1) - ldj)

    _, grads = filter_value_and_grad(loss_j)(flow_j)
    expected = {torch_name(k): v for k, v in jax_state(grads).items()}
    flow_t.zero_grad()
    y, ldj = flow_t(x_t)
    torch.mean(0.5 * torch.sum(y ** 2, dim=-1) - ldj).backward()
    named = dict(flow_t.named_parameters())
    assert set(named) == set(expected)
    for name, param in named.items():
        close(param.grad, expected[name], GRAD_ATOL)
    return y_t.detach(), ldj_t.detach()


def check_oracle(flow_t, x, ldj):
    """The port's log-det against its own brute-force oracle."""
    close(batch_log_abs_det_J(lambda z: flow_t(z)[0], t(x)), ldj)


# --------------------------------------------------------------------------
# PartialFlow
# --------------------------------------------------------------------------

@pytest.mark.parametrize('return_partial', [False, True])
def test_partial_flow(return_partial):
    n_features, fixed = 9, [7, 1, 4]
    n_propagated = n_features - len(fixed)
    inner_j, inner_t = inner_pair(n_propagated)
    flow_j = JaxPartial.create(inner_j, fixed, n_features=n_features,
                               return_partial=return_partial)
    flow_t = PartialFlow.create(inner_t, fixed, n_features=n_features,
                                return_partial=return_partial, device=CPU)
    x = frames(2, n_features)
    if return_partial:
        y_t, ldj_t = carry(flow_j, flow_t)(t(x))
        y_j, ldj_j = flow_j.forward(jnp.asarray(x))
        assert y_t.shape == (BATCH, n_propagated)
        close(y_t, y_j)
        close(ldj_t, ldj_j)
        return
    y, ldj = check_against_jax(flow_j, flow_t, x)
    # The fixed DOFs are copied through bit for bit.
    close(y[:, fixed], x[:, fixed], atol=0.0)
    x_back, ldj_inv = flow_t.inverse(y)
    close(x_back, x, atol=1e-8)
    close(ldj + ldj_inv, np.zeros(BATCH))
    check_oracle(flow_t, x, ldj)


class _Scaled(Flow):
    """Multiplies by a keyword argument: shows that it arrives."""

    def forward(self, x, scale=1.0):
        return x * scale, torch.full(x.shape[:1], x.shape[1] * np.log(scale),
                                     dtype=x.dtype)

    def inverse(self, y, scale=1.0):
        return y / scale, torch.full(y.shape[:1], -y.shape[1] * np.log(scale),
                                     dtype=y.dtype)


def test_partial_flow_threads_kwargs_and_buffers():
    flow = PartialFlow.create(_Scaled(), [0, 2], n_features=5, device=CPU)
    x = t(frames(3, 5))
    y, ldj = flow(x, scale=2.0)
    close(y[:, [1, 3, 4]], 2.0 * x[:, [1, 3, 4]], atol=0.0)
    close(y[:, [0, 2]], x[:, [0, 2]], atol=0.0)
    close(ldj, np.full(BATCH, 3 * np.log(2.0)))
    x_back, _ = flow.inverse(y, scale=2.0)
    close(x_back, x)
    assert flow.fixed_indices.tolist() == [0, 2]
    assert flow.propagated_indices.tolist() == [1, 3, 4]
    assert flow.fixed_indices_buf.dtype == torch.int64
    # Nothing fixed: the wrapped flow's output as it is.
    empty = PartialFlow.create(_Scaled(), [], n_features=5, device=CPU)
    close(empty(x, scale=3.0)[0], 3.0 * x, atol=0.0)


# --------------------------------------------------------------------------
# CenteredCentroidFlow
# --------------------------------------------------------------------------

@pytest.mark.parametrize('weights', [None, [1.0, 2.0, 3.0, 4.0, 5.0]])
@pytest.mark.parametrize('subset', [None, [0, 2, 4]])
def test_centered_centroid_flow(weights, subset):
    n_centroid_points = N_POINTS if subset is None else len(subset)
    if weights is not None:
        weights = weights[:n_centroid_points]
    inner_j, inner_t = inner_pair(N_DOFS - 3)
    kwargs = dict(space_dimension=3, n_features=N_DOFS,
                  subset_point_indices=subset, weights=weights)
    flow_j = JaxCentroid.create(inner_j, **kwargs)
    flow_t = CenteredCentroidFlow.create(inner_t, **kwargs, **ON_CPU)
    x = frames(1)
    y, ldj = check_against_jax(flow_j, flow_t, x)

    # The weighted centroid of the mapped configuration equals the input's.
    w = (np.full(n_centroid_points, 1 / n_centroid_points) if weights is None
         else np.asarray(weights, float) / np.sum(weights))
    pts = np.asarray(subset) if subset is not None else np.arange(N_POINTS)
    cent_x = np.einsum('p,bpd->bd', w, x.reshape(BATCH, -1, 3)[:, pts])
    cent_y = np.einsum('p,bpd->bd', w,
                       y.numpy().reshape(BATCH, -1, 3)[:, pts])
    close(cent_y, cent_x)

    x_back, ldj_inv = flow_t.inverse(y)
    close(x_back, x, atol=1e-8)
    close(ldj + ldj_inv, np.zeros(BATCH))
    check_oracle(flow_t, x, ldj)


def test_centered_centroid_error_paths():
    _, inner = inner_pair(N_DOFS - 3)
    kwargs = dict(space_dimension=3, n_features=N_DOFS, **ON_CPU)
    with pytest.raises(ValueError, match='translate_back'):
        CenteredCentroidFlow.create(inner, return_partial=True,
                                    translate_back=True, **kwargs)
    with pytest.raises(ValueError, match='origin'):
        CenteredCentroidFlow.create(inner, origin=[0.0, 1.0], **kwargs)
    with pytest.raises(ValueError, match='weights'):
        CenteredCentroidFlow.create(inner, subset_point_indices=[0, 1, 2],
                                    weights=[1.0, 2.0], **kwargs)
    # Inverse requires translate_back=True.
    flow = CenteredCentroidFlow.create(inner, translate_back=False, **kwargs)
    y, _ = flow(t(frames(10)))
    with pytest.raises(ValueError, match='translate_back'):
        flow.inverse(y)


@pytest.mark.parametrize('return_partial', [False, True])
def test_centered_centroid_custom_origin(return_partial):
    """A custom origin places the (internal) centroid there; without
    translate_back the output's centroid is the origin."""
    origin = [1.0, -2.0, 0.5]
    inner_j, inner_t = inner_pair(N_DOFS - 3)
    kwargs = dict(space_dimension=3, n_features=N_DOFS, origin=origin,
                  fixed_point_idx=2, translate_back=False,
                  return_partial=return_partial)
    flow_j = JaxCentroid.create(inner_j, **kwargs)
    flow_t = CenteredCentroidFlow.create(inner_t, **kwargs, **ON_CPU)
    x = frames(11)
    if return_partial:
        y_t, ldj_t = carry(flow_j, flow_t)(t(x))
        y_j, ldj_j = flow_j.forward(jnp.asarray(x))
        assert y_t.shape == (BATCH, N_DOFS - 3)
        close(y_t, y_j)
        close(ldj_t, ldj_j)
        return
    y, _ = check_against_jax(flow_j, flow_t, x, inverse=False)
    close(y.numpy().reshape(BATCH, -1, 3).mean(axis=1),
          np.tile(origin, (BATCH, 1)))


def test_centroid_buffers_follow_the_module():
    _, inner = inner_pair(N_DOFS - 3)
    flow = CenteredCentroidFlow.create(
        inner, space_dimension=3, n_features=N_DOFS, device=CPU)
    # Leaves that are None in JAX are listed on neither side.
    assert set(dict(flow.named_buffers(recurse=False))) == {
        'fixed_indices_buf', 'propagated_indices', 'origin'}
    assert flow.origin.dtype == torch.float32
    flow.double()
    assert flow.origin.dtype == torch.float64
    assert flow.fixed_indices_buf.dtype == torch.int64


# --------------------------------------------------------------------------
# OrientedFlow
# --------------------------------------------------------------------------

@pytest.mark.parametrize('perturbed', [False, True])
@pytest.mark.parametrize('axis,plane', [('z', 'xz'), ('x', 'xy'),
                                        ('y', 'yz')])
@pytest.mark.parametrize('axis_point_idx,plane_point_idx', [(0, 1), (2, 4)])
def test_oriented_flow(axis, plane, axis_point_idx, plane_point_idx,
                       perturbed):
    inner_j, inner_t = inner_pair(N_DOFS - 3, perturbed=perturbed)
    kwargs = dict(n_features=N_DOFS, axis_point_idx=axis_point_idx,
                  plane_point_idx=plane_point_idx, axis=axis, plane=plane,
                  rotate_back=False)
    flow_j = JaxOriented.create(inner_j, **kwargs)
    flow_t = OrientedFlow.create(inner_t, **kwargs, **ON_CPU)
    x = frames(2)
    y, _ = check_against_jax(flow_j, flow_t, x, inverse=False)
    y_atoms = y.numpy().reshape(BATCH, -1, 3)

    axis_dim = 'xyz'.index(axis)
    off_axis = [d for d in range(3) if d != axis_dim]
    # The axis point lies on the axis: other coordinates are zero.
    close(y_atoms[:, axis_point_idx][:, off_axis], np.zeros((BATCH, 2)),
          atol=0.0)
    # The plane point lies on the plane: its normal coordinate is zero.
    normal_dim = 'xyz'.index([c for c in 'xyz' if c not in plane][0])
    close(y_atoms[:, plane_point_idx][:, normal_dim], np.zeros(BATCH),
          atol=0.0)
    if not perturbed:
        # Rotations preserve distances from the origin.
        close(np.linalg.norm(y_atoms, axis=-1),
              np.linalg.norm(x.reshape(BATCH, -1, 3), axis=-1))


def test_oriented_flow_round_trip_and_jacobian():
    inner_j, inner_t = inner_pair(N_DOFS - 3)
    kwargs = dict(n_features=N_DOFS, axis_point_idx=0, plane_point_idx=1,
                  axis='z', plane='xz', rotate_back=True)
    flow_j = JaxOriented.create(inner_j, **kwargs)
    flow_t = OrientedFlow.create(inner_t, **kwargs, **ON_CPU)
    x = frames(3)
    y, ldj = check_against_jax(flow_j, flow_t, x)
    x_back, ldj_inv = flow_t.inverse(y)
    close(x_back, x, atol=1e-8)
    close(ldj + ldj_inv, np.zeros(BATCH))
    # The full R^(3N) map's log-det matches the oracle only with the frame
    # volume element, since the wrapped flow moves the radial frame DOFs.
    check_oracle(flow_t, x, ldj)


def test_centroid_oriented_composition_jacobian():
    """Centroid(Oriented(MAF)): the CartesianMAFMap wrapper stack."""
    inner_j, inner_t = inner_pair(N_DOFS - 6, seed=11)
    oriented = dict(n_features=N_DOFS - 3, axis_point_idx=0,
                    plane_point_idx=1, axis='z', plane='xz')
    centroid = dict(space_dimension=3, n_features=N_DOFS,
                    subset_point_indices=[2])
    flow_j = JaxCentroid.create(JaxOriented.create(inner_j, **oriented),
                                **centroid)
    flow_t = CenteredCentroidFlow.create(
        OrientedFlow.create(inner_t, **oriented, **ON_CPU), **centroid,
        **ON_CPU)
    x = frames(12)
    y, ldj = check_against_jax(flow_j, flow_t, x)
    check_oracle(flow_t, x, ldj)
    x_back, _ = flow_t.inverse(y)
    close(x_back, x, atol=1e-8)


def test_oriented_flow_error_paths():
    _, inner = inner_pair(N_DOFS - 3)
    kwargs = dict(n_features=N_DOFS, **ON_CPU)
    with pytest.raises(ValueError, match='different'):
        OrientedFlow.create(inner, axis_point_idx=1, plane_point_idx=1,
                            **kwargs)
    with pytest.raises(ValueError, match='plane'):
        OrientedFlow.create(inner, axis='z', plane='xy', **kwargs)
    with pytest.raises(ValueError, match='rotate_back'):
        OrientedFlow.create(inner, return_partial=True, rotate_back=True,
                            **kwargs)
    flow = OrientedFlow.create(inner, rotate_back=False, **kwargs)
    y, _ = flow(t(frames(4)))
    with pytest.raises(ValueError, match='rotate_back'):
        flow.inverse(y)


@pytest.mark.parametrize('given', [{}, {'plane_point_idx': 0},
                                   {'axis_point_idx': 0},
                                   {'axis_point_idx': 3}])
def test_oriented_flow_automatic_reference_points(given):
    """Defaults pick atoms 0/1, avoiding whichever the caller pinned."""
    _, inner = inner_pair(N_DOFS - 3)
    flow_t = OrientedFlow.create(inner, n_features=N_DOFS, **given, **ON_CPU)
    flow_j = JaxOriented.create(inner_pair(N_DOFS - 3)[0],
                                n_features=N_DOFS, **given)
    assert (flow_t.axis_point_idx, flow_t.plane_point_idx) == \
        (flow_j.axis_point_idx, flow_j.plane_point_idx)
    assert flow_t.fixed_indices.tolist() == \
        np.asarray(flow_j.fixed_indices_buf).tolist()


def test_oriented_flow_return_partial():
    """return_partial exposes only the propagated (unconstrained) DOFs."""
    inner_j, inner_t = inner_pair(N_DOFS - 3)
    kwargs = dict(n_features=N_DOFS, rotate_back=False, return_partial=True)
    flow_t = carry(JaxOriented.create(inner_j, **kwargs),
                   OrientedFlow.create(inner_t, **kwargs, **ON_CPU))
    x = frames(9)
    y_t, ldj_t = flow_t(t(x))
    y_j, ldj_j = JaxOriented.create(inner_j, **kwargs).forward(
        jnp.asarray(x))
    assert y_t.shape == (BATCH, N_DOFS - 3)
    close(y_t, y_j)
    close(ldj_t, ldj_j)


# --------------------------------------------------------------------------
# PCAWhitenedFlow
# --------------------------------------------------------------------------

def _pca_data(n_features=6, n_samples=500):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(n_features, n_features))
    return rng.normal(size=(n_samples, n_features)) @ a


@pytest.mark.parametrize('blacken', [True, False])
def test_pca_whitened_flow(blacken):
    data = _pca_data()
    inner_j, inner_t = inner_pair(6, seed=7)
    flow_j = JaxPCA.create(inner_j, data, blacken=blacken)
    flow_t = PCAWhitenedFlow.create(inner_t, torch.as_tensor(data),
                                    blacken=blacken, **ON_CPU)
    # The port's own fit (numpy float64 on the host), before any carry.
    for name in ('mean', 'whitening_matrix', 'blackening_matrix',
                 'whitening_log_det_J'):
        close(getattr(flow_t, name), getattr(flow_j, name))
    assert flow_t.whitening_log_det_J.shape == ()

    x = data[:BATCH]
    y, ldj = check_against_jax(flow_j, flow_t, x)
    x_back, ldj_inv = flow_t.inverse(y)
    close(x_back, x, atol=1e-8)
    close(ldj + ldj_inv, np.zeros(BATCH))
    check_oracle(flow_t, x, ldj)


def test_pca_negative_eigenvalue_raises():
    """Fewer samples than features: the covariance is singular, and where
    rounding makes an eigenvalue negative both packages refuse it."""
    inner_j, inner_t = inner_pair(6)
    raised = []
    for seed in range(20):
        data = np.random.default_rng(seed).normal(size=(3, 6))
        try:
            JaxPCA.create(inner_j, data)
        except ValueError:
            with pytest.raises(ValueError, match='negative'):
                PCAWhitenedFlow.create(inner_t, data, **ON_CPU)
            raised.append(seed)
        else:
            PCAWhitenedFlow.create(inner_t, data, **ON_CPU)
    assert raised


def test_pca_buffers_follow_the_module():
    _, inner = inner_pair(6)
    flow = PCAWhitenedFlow.create(inner, _pca_data(), device=CPU)
    assert flow.whitening_matrix.dtype == torch.float32
    flow.double()
    assert {b.dtype for b in flow.buffers(recurse=False)} == {torch.float64}
    # The whitened sample has unit covariance.
    flow = PCAWhitenedFlow.create(inner, _pca_data(), **ON_CPU)
    z = flow._whiten(t(_pca_data()))
    close(torch.cov(z.T), np.eye(6), atol=1e-10)
