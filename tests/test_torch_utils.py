"""The port's ``utils/{math,geometry,misc}.py`` against ``tfep_tpu.utils``.

One case for each case of ``tests/parity/test_utils_parity.py``: the same
inputs, made with numpy from a seed, go through the JAX function and the
port's, in float64 on the CPU, and agree at ``ATOL``.
"""

import doctest
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfep_tpu.utils import geometry as jax_geo
from tfep_tpu.utils import math as jax_math
from tfep_tpu.utils import misc as jax_misc
from tfep_tpu_torch.utils import geometry, math, misc

from test_torch_common import ATOL, close, t


def rng(seed=123):
    return np.random.default_rng(seed)


@pytest.mark.parametrize('with_pairs', [False, True])
def test_pdist(with_pairs):
    x = rng().standard_normal((4, 5, 3))
    pairs = np.array([[0, 1], [2, 4], [3, 0]]).T if with_pairs else None
    d_j, diff_j = jax_geo.pdist(x, pairs=pairs, return_diff=True)
    d_t, diff_t = geometry.pdist(t(x), pairs=pairs, return_diff=True)
    close(d_t, d_j)
    close(diff_t, diff_j)
    close(geometry.pdist(t(x), pairs=pairs), d_j)


@pytest.mark.parametrize('name', ['vector_vector_angle',
                                  'vector_plane_angle'])
def test_angles(name):
    x1 = rng().standard_normal((7, 3))
    x2 = rng(1).standard_normal(3)
    close(getattr(geometry, name)(t(x1), t(x2)),
          getattr(jax_geo, name)(x1, x2))
    # Parallel and antiparallel vectors: the cosine is clipped to [-1, 1].
    edge = np.stack([x2, -x2, 2.0 * x2])
    close(getattr(geometry, name)(t(edge), t(x2)),
          getattr(jax_geo, name)(edge, x2))


def test_proper_dihedral_angle():
    x1, x2, x3 = rng().standard_normal((3, 9, 3))
    close(geometry.proper_dihedral_angle(t(x1), t(x2), t(x3)),
          jax_geo.proper_dihedral_angle(x1, x2, x3))


@pytest.mark.parametrize('shared_direction', [False, True])
def test_rotation_matrix_3d(shared_direction):
    angles = rng().uniform(-np.pi, np.pi, size=6)
    directions = rng(1).standard_normal(
        3 if shared_direction else (6, 3))
    rot = geometry.rotation_matrix_3d(t(angles), t(directions))
    close(rot, jax_geo.rotation_matrix_3d(angles, directions))
    # Proper rotations.
    close(rot @ rot.transpose(1, 2), np.broadcast_to(np.eye(3), (6, 3, 3)))
    close(torch.linalg.det(rot), np.ones(6))


@pytest.mark.parametrize('inverse', [False, True])
def test_batchwise_rotate(inverse):
    x = rng().standard_normal((4, 5, 3))
    angles = rng(1).uniform(-np.pi, np.pi, size=4)
    directions = rng(2).standard_normal((4, 3))
    close(geometry.batchwise_rotate(
              t(x), geometry.rotation_matrix_3d(t(angles), t(directions)),
              inverse=inverse),
          jax_geo.batchwise_rotate(
              x, jax_geo.rotation_matrix_3d(angles, directions),
              inverse=inverse))


@pytest.mark.parametrize('name', ['x', 'y', 'z'])
def test_get_axis_from_name(name):
    np.testing.assert_array_equal(geometry.get_axis_from_name(name).numpy(),
                                  np.asarray(jax_geo.get_axis_from_name(name)))


def _plane_vectors(axis, plane):
    eye = np.eye(3)
    other = [c for c in plane if c != axis][0]
    plane_axis = eye['xyz'.index(other)]
    return plane_axis, np.cross(eye['xyz'.index(axis)], plane_axis)


@pytest.mark.parametrize('project_on_positive_axis', [False, True])
@pytest.mark.parametrize('axis,plane', [('x', 'xy'), ('z', 'xz'),
                                        ('y', 'yz')])
def test_reference_frame_rotation_matrix(axis, plane,
                                         project_on_positive_axis):
    axis_pos = rng().standard_normal((6, 3))
    plane_pos = rng(1).standard_normal((6, 3))
    axis_v = np.eye(3)['xyz'.index(axis)]
    # Degenerate rows: the axis atom already on the axis, on either side.
    axis_pos[4] = 1.7 * axis_v
    axis_pos[5] = -0.4 * axis_v
    plane_axis, plane_normal = _plane_vectors(axis, plane)
    kwargs = dict(axis=axis_v, plane_axis=plane_axis,
                  project_on_positive_axis=project_on_positive_axis)
    for normal in (None, plane_normal):
        ours = geometry.reference_frame_rotation_matrix(
            t(axis_pos), t(plane_pos), plane_normal=normal, **kwargs)
        close(ours, jax_geo.reference_frame_rotation_matrix(
            axis_pos, plane_pos, plane_normal=normal, **kwargs))
    # The axis atom lands on the axis, the plane atom on the plane.
    rotated_axis = torch.einsum('bij,bj->bi', ours, t(axis_pos))
    rotated_plane = torch.einsum('bij,bj->bi', ours, t(plane_pos))
    off_axis = [d for d in range(3) if axis_v[d] == 0.0]
    close(rotated_axis[:, off_axis], np.zeros((6, 2)))
    close(rotated_plane @ t(plane_normal), np.zeros(6))


@pytest.mark.parametrize('return_log_det_J', [False, True])
def test_polar_round_trip(return_log_det_J):
    x, y = 2.0 * rng().standard_normal((2, 20))
    ours = geometry.cartesian_to_polar(t(x), t(y),
                                       return_log_det_J=return_log_det_J)
    theirs = jax_geo.cartesian_to_polar(x, y,
                                        return_log_det_J=return_log_det_J)
    for a, b in zip(ours, theirs, strict=True):
        close(a, b)
    back = geometry.polar_to_cartesian(*ours[:2],
                                       return_log_det_J=return_log_det_J)
    theirs_back = jax_geo.polar_to_cartesian(
        *theirs[:2], return_log_det_J=return_log_det_J)
    for a, b in zip(back, theirs_back, strict=True):
        close(a, b)
    close(back[0], x)
    close(back[1], y)


@pytest.mark.parametrize('keepdim', [False, True])
def test_batchwise_dot_outer(keepdim):
    x1, x2 = rng().standard_normal((2, 8, 5))
    close(math.batchwise_dot(t(x1), t(x2), keepdim=keepdim),
          jax_math.batchwise_dot(x1, x2, keepdim=keepdim))
    close(math.batchwise_outer(t(x1), t(x2)),
          jax_math.batchwise_outer(x1, x2))


@pytest.mark.parametrize('dim_sample', [0, 1])
@pytest.mark.parametrize('ddof', [0, 1])
def test_cov(ddof, dim_sample):
    x = rng().standard_normal((40, 6))
    if dim_sample == 1:
        x = x.T
    x_t = t(x)
    close(math.cov(x_t, ddof=ddof, dim_sample=dim_sample),
          jax_math.cov(x, ddof=ddof, dim_sample=dim_sample))
    close(x_t, x, atol=0.0)


def test_log_det_oracle():
    """Both packages' brute-force log-det oracles agree on one function,
    and the port's Jacobian equals the analytic one."""
    x = rng().standard_normal((5, 4))
    close(math.batch_log_abs_det_J(
              lambda z: z * torch.exp(0.1 * z) + 0.3 * z ** 2, t(x)),
          jax_math.batch_log_abs_det_J(
              lambda z: z * jnp.exp(0.1 * z) + 0.3 * z ** 2, x))

    a = rng(1).standard_normal((4, 4))
    jac = math.batch_autograd_jacobian(lambda z: torch.tanh(z) @ t(a), t(x))
    expected = (1.0 - np.tanh(x) ** 2)[:, :, None] * a[None]
    close(jac, expected.transpose(0, 2, 1))
    assert math.batch_autograd_log_abs_det_J is math.batch_log_abs_det_J


@pytest.mark.parametrize('remove', [False, True])
@pytest.mark.parametrize('shift', [False, True])
def test_remove_and_shift_sorted_indices(remove, shift):
    indices = np.array([0, 2, 3, 5, 7, 9])
    removed = np.array([2, 5, 6])
    np.testing.assert_array_equal(
        misc.remove_and_shift_sorted_indices(indices, removed, remove=remove,
                                             shift=shift),
        jax_misc.remove_and_shift_sorted_indices(indices, removed,
                                                 remove=remove, shift=shift))


@pytest.mark.parametrize('as_tensor', [False, True])
def test_atom_and_flattened(as_tensor):
    positions = rng().standard_normal((3, 4, 3))
    wrap = t if as_tensor else np.asarray
    flat = misc.atom_to_flattened(wrap(positions))
    close(flat, jax_misc.atom_to_flattened(positions))
    close(misc.flattened_to_atom(flat), positions)
    close(misc.atom_to_flattened(wrap(positions[0])), positions[0].ravel())
    close(misc.flattened_to_atom(wrap(positions[0].ravel())), positions[0])

    atoms = np.array([[1, 3], [0, 2]])
    for index in (atoms, atoms[0]):
        ours = misc.atom_to_flattened_indices(
            torch.as_tensor(index) if as_tensor else index)
        assert isinstance(ours, torch.Tensor) == as_tensor
        np.testing.assert_array_equal(
            np.asarray(ours), jax_misc.atom_to_flattened_indices(index))


@pytest.mark.parametrize('value', [None, 3, [1, 2], np.array([4, 0])])
def test_ensure_int_array(value):
    ours = misc.ensure_int_array(value)
    if value is None:
        assert ours is None and jax_misc.ensure_int_array(value) is None
        return
    assert ours.dtype == np.int64
    np.testing.assert_array_equal(ours, jax_misc.ensure_int_array(value))


def test_temporary_cd_and_clear_directory(tmp_path):
    start = os.getcwd()
    with misc.temporary_cd(None):
        assert os.getcwd() == start
    (tmp_path / 'sub').mkdir()
    (tmp_path / 'sub' / 'f').write_text('x')
    (tmp_path / 'g').write_text('y')
    outside = tmp_path.parent / f'{tmp_path.name}_kept'
    outside.mkdir()
    (tmp_path / 'link').symlink_to(outside)
    with misc.temporary_cd(tmp_path):
        assert os.getcwd() == str(tmp_path)
        misc.clear_directory('.')
    assert os.getcwd() == start
    assert list(tmp_path.iterdir()) == []
    assert outside.is_dir()  # the symlink was unlinked, not followed


def test_misc_doctests():
    results = doctest.testmod(misc, optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.failed == 0 and results.attempted > 0
