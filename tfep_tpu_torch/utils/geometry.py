"""Geometry utilities: distances, angles, rotations, frame fixing, polar maps.

Port of ``tfep_tpu/utils/geometry.py``: fully batched, every conditional a
``torch.where`` select, no in-place write. Where PyTorch's defaults differ
from ``jax.numpy``'s, the JAX package's are given explicitly (the
``isclose`` tolerances, the ``cross`` dimension).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tfep_tpu_torch.utils.math import batchwise_dot, batchwise_outer

__all__ = [
    'pdist', 'vector_vector_angle', 'vector_plane_angle',
    'proper_dihedral_angle', 'rotation_matrix_3d', 'batchwise_rotate',
    'get_axis_from_name', 'reference_frame_rotation_matrix',
    'cartesian_to_polar', 'polar_to_cartesian',
]

# jnp.isclose's defaults.
_ISCLOSE_RTOL = 1e-5
_ISCLOSE_ATOL = 1e-8


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def pdist(x, pairs=None, return_diff: bool = False):
    """Euclidean distances between particle pairs, batched.

    ``x``: (batch, n_particles, D); ``pairs``: (2, n_pairs) or None (all
    unique pairs). Returns (batch, n_pairs) distances (+ optional diffs
    ``p1 - p0`` of shape (batch, n_pairs, D)).
    """
    if pairs is None:
        pairs = np.stack(np.triu_indices(x.shape[-2], k=1))
    pairs = torch.as_tensor(pairs, device=x.device)
    diff = x[:, pairs[1]] - x[:, pairs[0]]
    distances = torch.sqrt(torch.sum(diff ** 2, dim=-1))
    if return_diff:
        return distances, diff
    return distances


def vector_vector_angle(x1, x2):
    """Angle in [0, pi] between vectors, batched over leading dims."""
    cos_theta = batchwise_dot(x1, x2) / (
        torch.linalg.norm(x1, dim=-1) * torch.linalg.norm(x2, dim=-1))
    return torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))


def vector_plane_angle(x, plane):
    """Angle between vectors and a plane given by its normal vector."""
    cos_theta = batchwise_dot(x, plane) / (
        torch.linalg.norm(x, dim=-1) * torch.linalg.norm(plane, dim=-1))
    return torch.arcsin(torch.clamp(cos_theta, -1.0, 1.0))


def proper_dihedral_angle(x1, x2, x3):
    """Proper dihedral angle (in (-pi, pi]) from three bond vectors.

    ``x1 = p1-p0``, ``x2 = p2-p1``, ``x3 = p3-p2`` with shapes ``(*, 3)``.
    """
    x1 = -x1
    x2 = x2 / torch.linalg.norm(x2, dim=-1, keepdim=True)
    v = x1 - batchwise_dot(x1, x2, keepdim=True) * x2
    w = x3 - batchwise_dot(x3, x2, keepdim=True) * x2
    x = batchwise_dot(v, w)
    y = batchwise_dot(_cross(x2, v), w)
    return torch.arctan2(y, x)


def rotation_matrix_3d(angles, directions):
    """Rodrigues rotation matrices: rotate by ``angles`` about ``directions``.

    ``angles``: (batch,), ``directions``: (batch, 3) or (3,). Returns
    (batch, 3, 3).
    """
    angles = torch.as_tensor(angles)
    directions = torch.as_tensor(directions, device=angles.device)
    if directions.ndim < 2:
        directions = directions[None].expand(angles.shape[0], 3)
    sina = torch.sin(angles)
    cosa = torch.cos(angles)
    norms = torch.linalg.norm(directions, dim=-1, keepdim=True)
    k = directions / torch.where(norms > 0, norms, torch.ones_like(norms))

    eye = torch.eye(3, dtype=angles.dtype, device=angles.device)
    R = cosa[:, None, None] * eye[None]
    R = R + (1 - cosa)[:, None, None] * batchwise_outer(k, k)
    sk = sina[:, None] * k
    zeros = torch.zeros_like(angles)
    cross = torch.stack([
        torch.stack([zeros, -sk[:, 2], sk[:, 1]], dim=-1),
        torch.stack([sk[:, 2], zeros, -sk[:, 0]], dim=-1),
        torch.stack([-sk[:, 1], sk[:, 0], zeros], dim=-1),
    ], dim=-2)
    return R + cross


def batchwise_rotate(x, rotation_matrices, inverse: bool = False):
    """Rotate (batch, n_vectors, 3) points by per-sample (batch, 3, 3)
    matrices (by their transposes with ``inverse``)."""
    if inverse:
        rotation_matrices = rotation_matrices.transpose(1, 2)
    return torch.einsum('bij,bkj->bik', x, rotation_matrices)


_AXIS_NAME_TO_VECTOR = {
    'x': (1.0, 0.0, 0.0),
    'y': (0.0, 1.0, 0.0),
    'z': (0.0, 0.0, 1.0),
}


def get_axis_from_name(name: str) -> torch.Tensor:
    """Unit vector for an axis name ('x' | 'y' | 'z'), in the default
    floating-point type."""
    return torch.tensor(_AXIS_NAME_TO_VECTOR[name])


def reference_frame_rotation_matrix(
        axis_atom_positions, plane_atom_positions, axis, plane_axis,
        plane_normal: Optional[torch.Tensor] = None,
        project_on_positive_axis: bool = False):
    """Rotation matrices fixing the frame: axis atom onto ``axis``, plane atom
    onto the ``axis``-``plane_axis`` plane.

    With ``project_on_positive_axis=False`` (default) the axis atom rotates to
    whichever half-axis is closer, keeping the map invertible.
    """
    like = dict(dtype=axis_atom_positions.dtype,
                device=axis_atom_positions.device)
    axis = torch.as_tensor(axis, **like)
    plane_axis = torch.as_tensor(plane_axis, **like)
    if plane_normal is None:
        plane_normal = _cross(axis, plane_axis)
    else:
        plane_normal = torch.as_tensor(plane_normal, **like)

    rotation_vectors = _cross(axis_atom_positions, axis[None, :])
    # Degenerate case: axis atom already on the axis -> any perpendicular.
    is_parallel = torch.all(
        torch.isclose(rotation_vectors, torch.zeros_like(rotation_vectors),
                      rtol=_ISCLOSE_RTOL, atol=_ISCLOSE_ATOL),
        dim=1, keepdim=True)
    fallback = _cross(plane_axis, axis)
    rotation_vectors = torch.where(is_parallel, fallback[None, :],
                                   rotation_vectors)

    r1_angles = vector_vector_angle(axis_atom_positions, axis)
    if not project_on_positive_axis:
        r1_angles = r1_angles - torch.pi * (r1_angles > torch.pi / 2).to(
            r1_angles.dtype)
    r1 = rotation_matrix_3d(r1_angles, rotation_vectors)

    plane_points = batchwise_rotate(plane_atom_positions[:, None], r1)[:, 0]
    plane_points = plane_points - axis[None, :] * batchwise_dot(
        plane_points, axis, keepdim=True)
    r2_angles = vector_plane_angle(plane_points, plane_normal)
    r2_sign = -torch.sign(batchwise_dot(plane_points, plane_axis))
    r2 = rotation_matrix_3d(r2_sign * r2_angles, axis)

    return torch.einsum('bij,bjk->bik', r2, r1)


def cartesian_to_polar(x, y, return_log_det_J: bool = False):
    """(x, y) -> (r, angle); log|det J| = -log r."""
    r = torch.sqrt(x ** 2 + y ** 2)
    angle = torch.arctan2(y, x)
    if return_log_det_J:
        return r, angle, -torch.log(r)
    return r, angle


def polar_to_cartesian(r, angle, return_log_det_J: bool = False):
    """(r, angle) -> (x, y); log|det J| = log r."""
    x = r * torch.cos(angle)
    y = r * torch.sin(angle)
    if return_log_det_J:
        return x, y, torch.log(r)
    return x, y
