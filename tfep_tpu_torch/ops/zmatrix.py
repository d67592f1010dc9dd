"""Cartesian <-> internal (Z-matrix) coordinates with exact log-det.

Port of ``tfep_tpu/ops/zmatrix.py``. Each Z-matrix row ``[i, j, k, l]``
describes atom ``i`` by its bond length to ``j``, the angle i-j-k and the
proper dihedral i-j-k-l; the reference atoms are Cartesian atoms or atoms
of earlier rows.

The measurement (Cartesian -> internal) is one gather and trigonometry.
The reconstruction places atoms NeRF-style, level by level: a row whose
reference atoms are all placed belongs to the next level, and all rows of
a level are placed together, so the loop runs over the depth of the
placement graph, not over rows. The JAX package pads every level to one
width and drops the padded slots with an out-of-bounds scatter inside a
``lax.scan`` or an unrolled loop; here each level keeps its own unpadded
index tensors, built once on the device, and an eager loop writes each
level out of place (``index_copy``), never into a tensor autograd saved.

The per-row volume element is ``r^2 sin(theta)``, so
``log|det d(ic)/d(cart)| = sum_rows [-2 log r - log sin(theta)]`` plus the
normalization factors: with ``normalize_angles=True`` angles map to
``theta/pi`` and torsions to ``(phi+pi)/(2 pi)``, contributing
``-log(pi) - log(2 pi)`` per row.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tfep_tpu_torch.device import StaticIndices, resolve_device
from tfep_tpu_torch.utils.geometry import (
    proper_dihedral_angle, vector_vector_angle,
)

__all__ = [
    'cartesian_to_internal', 'internal_to_cartesian',
    'normalize_angles_fn', 'unnormalize_angles_fn',
    'normalize_torsions_fn', 'unnormalize_torsions_fn',
    'build_placement_schedule', 'PlacementSchedule',
]


# =============================================================================
# Angle normalization (bgflow-compatible conventions)
# =============================================================================

def _full(like, value):
    return torch.full(like.shape[:-1], value, dtype=like.dtype,
                      device=like.device)


def normalize_angles_fn(angles):
    """[0, pi] -> [0, 1]; per-element log-det = -log(pi)."""
    return angles / torch.pi, _full(angles,
                                    -np.log(np.pi) * angles.shape[-1])


def unnormalize_angles_fn(angles):
    return angles * torch.pi, _full(angles, np.log(np.pi) * angles.shape[-1])


def normalize_torsions_fn(torsions):
    """(-pi, pi] -> [0, 1]; per-element log-det = -log(2 pi)."""
    return (torsions + torch.pi) / (2 * torch.pi), _full(
        torsions, -np.log(2 * np.pi) * torsions.shape[-1])


def unnormalize_torsions_fn(torsions):
    return torsions * (2 * torch.pi) - torch.pi, _full(
        torsions, np.log(2 * np.pi) * torsions.shape[-1])


# =============================================================================
# Measurement: Cartesian -> internal
# =============================================================================

def cartesian_to_internal(x_atoms: torch.Tensor, z_matrix,
                          normalize_angles: bool = True):
    """Measure bonds/angles/torsions for every Z-matrix row.

    Parameters
    ----------
    x_atoms : torch.Tensor, shape (batch, n_atoms, 3)
        All atom positions (Cartesian + IC atoms, original indexing).
    z_matrix : (n_ic, 4) int array or tensor
        Rows ``[i, j, k, l]``.
    normalize_angles : bool
        Normalize angles/torsions to [0, 1] (bgflow ``normalize_angles``).

    Returns
    -------
    bonds, angles, torsions : (batch, n_ic)
    log_det_J : (batch,)
        log|det| of the (cart -> ic) map restricted to the IC atoms' DOFs.
    """
    z = torch.as_tensor(z_matrix, device=x_atoms.device)
    batch, n_ic = x_atoms.shape[0], z.shape[0]
    # One gather of all four atoms of every row.
    p = x_atoms.index_select(1, z.reshape(-1)).reshape(batch, n_ic, 4, 3)
    p_i, p_j, p_k, p_l = p.unbind(2)

    v_ij = p_i - p_j
    bonds = torch.linalg.norm(v_ij, dim=-1)
    angles = vector_vector_angle(v_ij, p_k - p_j)
    # Dihedral i-j-k-l: x1 = p_j - p_i, x2 = p_k - p_j, x3 = p_l - p_k.
    torsions = proper_dihedral_angle(p_j - p_i, p_k - p_j, p_l - p_k)

    log_det_J = torch.sum(-2.0 * torch.log(bonds)
                          - torch.log(torch.sin(angles)), dim=-1)

    if normalize_angles:
        angles, ldj_a = normalize_angles_fn(angles)
        torsions, ldj_t = normalize_torsions_fn(torsions)
        log_det_J = log_det_J + ldj_a + ldj_t

    return bonds, angles, torsions, log_det_J


# =============================================================================
# Reconstruction: internal -> Cartesian (NeRF placement, level by level)
# =============================================================================

def _place_atom(p_j, p_k, p_l, r, theta, phi):
    """NeRF placement of one atom from its three reference positions.

    Chosen so that measuring (bond, angle, dihedral) of the placed atom with
    :func:`cartesian_to_internal` conventions recovers (r, theta, phi).
    """
    v_jk = p_k - p_j
    v_kl = p_l - p_k

    e1 = v_jk / torch.linalg.norm(v_jk, dim=-1, keepdim=True)
    n = torch.linalg.cross(v_kl, v_jk, dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    m = torch.linalg.cross(n, e1, dim=-1)

    # Angle theta from the j->k direction, dihedral phi about it; -cos(phi)
    # makes the measured proper dihedral equal phi.
    d = (r[..., None]
         * (torch.cos(theta)[..., None] * e1
            + torch.sin(theta)[..., None] * (-torch.cos(phi)[..., None] * m
                                             + torch.sin(phi)[..., None] * n)))
    return p_j + d


def build_placement_schedule(z_matrix, n_atoms: int):
    """The JAX package's padded placement plan (host side, numpy).

    Returns ``(targets, refs, cols)``, each with one row per dependency
    level, padded to the widest level: the atom each slot writes
    (``n_atoms`` and above for padded slots), its three reference atoms,
    and the Z-matrix row its (bond, angle, torsion) live in.
    """
    z = np.asarray(z_matrix, dtype=np.int64).reshape(-1, 4)
    schedule = _level_schedule(z)
    padded = schedule < 0
    safe_rows = np.where(padded, 0, schedule)
    # Distinct out-of-bounds targets for the padded slots, as in JAX.
    oob = n_atoms + np.cumsum(padded, axis=1) - 1
    targets = np.where(padded, np.maximum(oob, n_atoms), z[safe_rows][..., 0])
    refs = z[safe_rows][..., 1:]
    return targets, refs, safe_rows


def _level_rows(z_matrix):
    """The Z-matrix rows of each level, unpadded, in row order."""
    schedule = _level_schedule(np.asarray(z_matrix, dtype=np.int64)
                               .reshape(-1, 4))
    return [level[level >= 0] for level in schedule]


class PlacementSchedule(nn.Module):
    """The level-scheduled placement plan of a Z-matrix, on the device.

    Its buffers ``0``, ``1``, ``2`` are the JAX package's padded plan
    (:func:`build_placement_schedule`), kept so that the JAX module's
    ``placement_schedule`` leaves load; the placement itself reads
    :attr:`levels`: per level, the unpadded target atoms, the three
    reference atoms of each row (flattened) and the rows, built once.
    """

    def __init__(self, z_matrix, n_atoms: int, device=None):
        super().__init__()
        device = resolve_device(device)
        z = np.asarray(z_matrix, dtype=np.int64).reshape(-1, 4)
        for name, array in zip('012', build_placement_schedule(z, n_atoms)):
            self.register_buffer(name, torch.as_tensor(array, device=device))
        rows = _level_rows(z)
        self.tables = StaticIndices(
            device, targets=tuple(z[r, 0] for r in rows),
            refs=tuple(z[r, 1:].reshape(-1) for r in rows),
            rows=tuple(rows))

    @property
    def n_levels(self) -> int:
        return len(self.tables['rows'])

    @property
    def levels(self):
        """``[(targets, refs, rows), ...]``, one entry per level."""
        return list(zip(self.tables['targets'], self.tables['refs'],
                        self.tables['rows']))


def internal_to_cartesian(bonds: torch.Tensor, angles: torch.Tensor,
                          torsions: torch.Tensor,
                          positions_init: torch.Tensor, z_matrix,
                          normalize_angles: bool = True, schedule=None):
    """Reconstruct IC atom positions given the Cartesian reference atoms.

    Parameters
    ----------
    bonds, angles, torsions : (batch, n_ic)
        In the same (possibly normalized) convention as
        :func:`cartesian_to_internal`.
    positions_init : (batch, n_atoms, 3)
        Full positions with the Cartesian atoms' rows filled in (the IC
        atoms' rows are overwritten).
    z_matrix : (n_ic, 4)
    schedule : PlacementSchedule, optional
        The plan built once with the flow; built here from ``z_matrix``
        otherwise.

    Returns
    -------
    positions : (batch, n_atoms, 3)
    log_det_J : (batch,)
    """
    batch = bonds.shape[0]
    log_det_J = torch.zeros(batch, dtype=positions_init.dtype,
                            device=positions_init.device)
    if normalize_angles:
        angles, ldj_a = unnormalize_angles_fn(angles)
        torsions, ldj_t = unnormalize_torsions_fn(torsions)
        log_det_J = log_det_J + ldj_a + ldj_t

    # Volume element of (r, theta, phi) -> (x, y, z): r^2 sin(theta).
    log_det_J = log_det_J + torch.sum(
        2.0 * torch.log(bonds) + torch.log(torch.sin(angles)), dim=-1)

    if schedule is None:
        z = torch.as_tensor(z_matrix).cpu().numpy()
        schedule = PlacementSchedule(z, positions_init.shape[1],
                                     device=positions_init.device)

    ics = torch.stack([bonds, angles, torsions], dim=-1)    # (batch, n_ic, 3)
    positions = positions_init
    for targets, refs, rows in schedule.levels:
        width = rows.shape[0]
        p = positions.index_select(1, refs).reshape(batch, width, 3, 3)
        r, theta, phi = ics.index_select(1, rows).unbind(-1)
        p_i = _place_atom(p[:, :, 0], p[:, :, 1], p[:, :, 2], r, theta, phi)
        positions = positions.index_copy(1, targets, p_i)
    return positions, log_det_J


def _level_schedule(z_matrix: np.ndarray) -> np.ndarray:
    """Group Z-matrix rows by placement-dependency level (host side).

    A row's level is one more than the deepest of its reference atoms
    (Cartesian references have level 0). Returns an (n_levels, width)
    array of row indices, padded with -1.

    Raises
    ------
    ValueError
        If a row references an atom that a *later* row places (rows must
        be in dependency order): the reconstruction would otherwise read
        an unplaced position and return garbage silently.
    """
    z = np.asarray(z_matrix)
    if len(z) == 0:
        return np.zeros((0, 0), dtype=np.int64)
    placed_by_row = {int(row[0]): row_idx for row_idx, row in enumerate(z)}
    atom_level: dict = {}
    row_level = np.zeros(len(z), dtype=np.int64)
    for row_idx, (i, j, k, l) in enumerate(z):
        for ref in (int(j), int(k), int(l)):
            if placed_by_row.get(ref, -1) >= row_idx:
                raise ValueError(
                    f'Z-matrix row {row_idx} (atom {int(i)}) references '
                    f'atom {ref}, which is placed by the later row '
                    f'{placed_by_row[ref]}; rows must be in dependency '
                    'order (references are Cartesian atoms or earlier '
                    'rows).')
        level = 1 + max(atom_level.get(int(j), 0), atom_level.get(int(k), 0),
                        atom_level.get(int(l), 0))
        atom_level[int(i)] = level
        row_level[row_idx] = level

    groups = [np.nonzero(row_level == level)[0]
              for level in range(1, int(row_level.max()) + 1)]
    width = max(len(g) for g in groups)
    schedule = np.full((len(groups), width), -1, dtype=np.int64)
    for level_idx, group in enumerate(groups):
        schedule[level_idx, :len(group)] = group
    return schedule
