"""Shape and index utilities.

Port of ``tfep_tpu/utils/misc.py``. Index bookkeeping (atom-role
partitioning, fixed-atom removal) happens on the host with numpy when a
model is built; the flattened <-> atom reshapes work on tensors and numpy
arrays alike. ``energies_array_to_numpy`` and ``forces_array_to_numpy``
strip the units of :mod:`tfep_tpu_torch.units` quantities.
"""

from __future__ import annotations

import contextlib
import os
import shutil
from collections.abc import Sequence
from typing import Optional, Union

import numpy as np
import torch

__all__ = [
    'atom_to_flattened', 'flattened_to_atom', 'atom_to_flattened_indices',
    'ensure_int_array', 'remove_and_shift_sorted_indices', 'temporary_cd',
    'clear_directory', 'energies_array_to_numpy', 'forces_array_to_numpy',
    'energies_array_to_tensor', 'forces_array_to_tensor',
]


def atom_to_flattened(positions):
    """(batch, n_atoms, 3) -> (batch, n_atoms*3); also works unbatched."""
    if positions.ndim == 2:
        return positions.reshape(-1)
    return positions.reshape(positions.shape[0], -1)


def flattened_to_atom(positions):
    """(batch, n_atoms*3) -> (batch, n_atoms, 3); also works unbatched."""
    if positions.ndim == 1:
        return positions.reshape(-1, 3)
    return positions.reshape(positions.shape[0], -1, 3)


def atom_to_flattened_indices(atom_indices):
    """Convert atom indices to indices over the flattened DOF axis.

    ``[1, 3]`` -> ``[3, 4, 5, 9, 10, 11]``. A tensor gives a tensor on its
    device; anything else a numpy array.
    """
    if isinstance(atom_indices, torch.Tensor):
        offsets = torch.arange(3, device=atom_indices.device)
    else:
        atom_indices = np.asarray(atom_indices)
        offsets = np.arange(3)
    return (atom_indices[..., None] * 3 + offsets).reshape(
        *atom_indices.shape[:-1], -1)


def ensure_int_array(x: Union[int, Sequence, np.ndarray, None],
                     ) -> Optional[np.ndarray]:
    """Normalize index-like input to a 1D numpy int array (host-side)."""
    if x is None:
        return None
    arr = np.asarray(x)
    if arr.ndim == 0:
        arr = arr[None]
    return arr.astype(np.int64)


def remove_and_shift_sorted_indices(
        indices: np.ndarray,
        removed_indices: np.ndarray,
        remove: bool = True,
        shift: bool = True,
) -> np.ndarray:
    """Remove ``removed_indices`` (by value) from sorted ``indices`` and shift.

    After removal, remaining indices are shifted down so they index an array
    from which ``removed_indices``' elements have been deleted. Host-side
    (numpy): used when a model is built, to map atom indices to the reduced
    DOF space after fixed atoms are dropped.

    Examples
    --------
    >>> remove_and_shift_sorted_indices(
    ...     np.array([0, 3, 9, 13]), np.array([3, 12]), shift=False).tolist()
    [0, 9, 13]
    >>> remove_and_shift_sorted_indices(
    ...     np.array([0, 3, 9, 13]), np.array([3, 12])).tolist()
    [0, 8, 11]
    """
    indices = np.asarray(indices)
    removed_indices = np.asarray(removed_indices)
    insert_positions = np.searchsorted(removed_indices, indices)

    if remove:
        padded = np.concatenate([removed_indices, [-1]])
        keep = padded[insert_positions] != indices
        indices = indices[keep]
        insert_positions = insert_positions[keep]

    if shift:
        indices = indices - insert_positions
    return indices


def energies_array_to_numpy(energies, energy_unit=None, dtype=None):
    """Convert a Quantity of batch energies to a plain numpy array in ``energy_unit``."""
    from tfep_tpu_torch.units import Quantity
    if isinstance(energies, Quantity) and energy_unit is not None:
        energies = energies.to(energy_unit)
    magnitude = energies.magnitude if isinstance(energies, Quantity) else energies
    return np.asarray(magnitude, dtype=dtype)


def forces_array_to_numpy(forces, distance_unit=None, energy_unit=None,
                          dtype=None):
    """Convert a Quantity of forces (batch, n_atoms, 3) to flattened numpy.

    Returns shape ``(batch, n_atoms*3)`` in units of energy_unit/distance_unit.
    """
    from tfep_tpu_torch.units import Quantity
    if (energy_unit is None) != (distance_unit is None):
        raise ValueError(
            'Both or neither energy_unit and distance_unit must be passed.')
    if isinstance(forces, Quantity) and energy_unit is not None:
        forces = forces.to(energy_unit / distance_unit)
    magnitude = forces.magnitude if isinstance(forces, Quantity) else forces
    magnitude = np.asarray(magnitude, dtype=dtype)
    return magnitude.reshape(magnitude.shape[0], -1)


def clear_directory(dir_path):
    """Delete every entry inside ``dir_path`` (not the directory itself).

    Symlinks are unlinked, never followed.
    """
    for name in os.listdir(dir_path):
        path = os.path.join(dir_path, name)
        if os.path.isdir(path) and not os.path.islink(path):
            shutil.rmtree(path)
        else:
            os.unlink(path)


@contextlib.contextmanager
def temporary_cd(dir_path):
    """Temporarily change working directory (no-op when ``dir_path`` is None)."""
    if dir_path is None:
        yield
    else:
        old = os.getcwd()
        os.chdir(dir_path)
        try:
            yield
        finally:
            os.chdir(old)


#: The JAX package's aliases of the same names (plain numpy arrays there too).
energies_array_to_tensor = energies_array_to_numpy
forces_array_to_tensor = forces_array_to_numpy
