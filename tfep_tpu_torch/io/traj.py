"""Trajectory systems and the trajectory dataset, in memory.

The in-memory part of ``tfep_tpu/io/traj.py``, copied (numpy only): the
box conversions, :class:`System` built from a topology and an array of
frames, frame subsampling, :class:`Timestep` and
:class:`TrajectoryDataset`, whose samples are dicts
``{'positions' (n_atoms*3 flattened), 'dimensions' (box),
'dataset_sample_index', 'trajectory_sample_index', aux keys}``.

Reading and writing trajectory files (``System.from_file``,
``from_universe``, ``save``, ``load_topology``, ``read_pdb``, ``read_gro``,
``read_xyz``) is not ported yet: those raise ``NotImplementedError``.

Positions are in angstrom.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from tfep_tpu_torch.io.dataset import Dataset
from tfep_tpu_torch.io.topology import Topology, _needs_coordinates
from tfep_tpu_torch.units import Quantity, ureg

__all__ = ['System', 'Timestep', 'TrajectoryDataset', 'read_pdb',
           'read_gro', 'read_xyz', 'get_subsampled_indices',
           'box_vectors_to_dimensions', 'dimensions_to_box_vectors']

_NO_FILES = ('Reading and writing trajectory files is not ported to '
             'tfep_tpu_torch yet: build a System from a Topology and an '
             'array of frames.')


def box_vectors_to_dimensions(box_vectors: np.ndarray) -> np.ndarray:
    """Convert triclinic box vectors to unit-cell dimensions.

    Parameters
    ----------
    box_vectors : numpy.ndarray
        ``(..., 3, 3)`` row-vector boxes (any length unit).

    Returns
    -------
    numpy.ndarray
        ``(..., 6)`` as ``[lx, ly, lz, alpha, beta, gamma]`` with angles
        in degrees — the MDAnalysis ``dimensions`` convention the
        reference exposes to its maps. Degenerate (zero-length) vectors
        report 90-degree angles rather than NaN.
    """
    v = np.asarray(box_vectors, dtype=np.float64)
    lengths = np.linalg.norm(v, axis=-1)

    def angle(a, b):
        den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
        cos = np.where(den > 0, (a * b).sum(-1) / np.where(den > 0, den, 1.0),
                       0.0)
        return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))

    alpha = np.asarray(angle(v[..., 1, :], v[..., 2, :]))
    beta = np.asarray(angle(v[..., 0, :], v[..., 2, :]))
    gamma = np.asarray(angle(v[..., 0, :], v[..., 1, :]))
    # Degenerate (zero) vectors: report rectangular angles.
    for a in (alpha, beta, gamma):
        np.copyto(a, 90.0, where=(a == 0))
    return np.concatenate(
        [lengths, np.stack([alpha, beta, gamma], axis=-1)], axis=-1)


def dimensions_to_box_vectors(dimensions: np.ndarray) -> np.ndarray:
    """Convert unit-cell dimensions to triclinic box vectors.

    Inverse of :func:`box_vectors_to_dimensions` up to the standard
    orientation convention: the first vector lies on x, the second in the
    xy-plane, the third has a non-negative z-component.

    Parameters
    ----------
    dimensions : numpy.ndarray
        ``(..., 6)`` as ``[lx, ly, lz, alpha, beta, gamma]``, degrees.

    Returns
    -------
    numpy.ndarray
        ``(..., 3, 3)`` row-vector boxes.
    """
    dims = np.asarray(dimensions, dtype=np.float64)
    a, b, c = dims[..., 0], dims[..., 1], dims[..., 2]
    alpha = np.radians(dims[..., 3])
    beta = np.radians(dims[..., 4])
    gamma = np.radians(dims[..., 5])
    zeros = np.zeros_like(a)
    v1 = np.stack([a, zeros, zeros], axis=-1)
    v2 = np.stack([b * np.cos(gamma), b * np.sin(gamma), zeros], axis=-1)
    cx = c * np.cos(beta)
    cy = c * (np.cos(alpha) - np.cos(beta) * np.cos(gamma)) / np.sin(gamma)
    cz = np.sqrt(np.maximum(c ** 2 - cx ** 2 - cy ** 2, 0.0))
    v3 = np.stack([cx, cy, cz], axis=-1)
    return np.stack([v1, v2, v3], axis=-2)


class System:
    """Topology + trajectory frames (the framework's 'Universe').

    Plays the role MDAnalysis' ``Universe`` plays for the reference: one
    object carrying atom attributes (:class:`~tfep_tpu_torch.io.topology.Topology`),
    coordinates for every frame, per-frame unit-cell dimensions, and
    frame times. ``positions`` is an in-memory array (the lazy frame
    stores of the JAX package are not ported yet).
    """

    def __init__(self, topology: Topology, positions,
                 dimensions: Optional[np.ndarray] = None,
                 times: Optional[np.ndarray] = None):
        """``positions``: (n_frames, n_atoms, 3) angstrom. ``dimensions``:
        (n_frames, 6) box [lx, ly, lz, alpha, beta, gamma] or None.
        ``times``: (n_frames,) ps or None (defaults to frame index)."""
        self.topology = topology
        self.positions = np.asarray(positions, dtype=np.float32)
        if self.positions.ndim == 2:
            self.positions = self.positions[None]
        if dimensions is None:
            self.dimensions = None
        else:
            self.dimensions = np.asarray(dimensions, dtype=np.float32)
            if self.dimensions.ndim == 1:  # single-frame (6,) spelling
                self.dimensions = self.dimensions[None]
        self.times = (np.arange(self.n_frames, dtype=np.float64)
                      if times is None else np.asarray(times, np.float64))

    @property
    def n_frames(self) -> int:
        return self.positions.shape[0]

    @property
    def n_atoms(self) -> int:
        return self.positions.shape[1]

    def select_atoms(self, selection, frame: int = 0) -> np.ndarray:
        """Resolve a selection string / index list to sorted atom indices.

        Geometric selections (``around``/``within``/``sphzone``/``point``;
        see :mod:`tfep_tpu_torch.io.topology`) are evaluated against ``frame``'s
        coordinates and box with periodic minimum-image distances — the
        counterpart of the MDAnalysis selection strings the reference
        accepts (upstream tfep/app/base.py:906-944).
        """
        positions = dimensions = None
        if isinstance(selection, str) and _needs_coordinates(selection):
            positions = np.asarray(self.positions[frame])
            if self.dimensions is not None:
                dimensions = self.dimensions[frame]
        return self.topology.select_atoms(selection, positions=positions,
                                          dimensions=dimensions)

    @classmethod
    def from_file(cls, path: str, topology_path: Optional[str] = None,
                  lazy: bool = False) -> 'System':
        """Load from a trajectory file: not ported yet (raises)."""
        raise NotImplementedError(_NO_FILES)

    @classmethod
    def from_universe(cls, universe) -> 'System':
        """Build from an MDAnalysis ``Universe``: not ported yet (raises)."""
        raise NotImplementedError(_NO_FILES)

    def save(self, path: str, positions=None, **kwargs) -> None:
        """Write the frames to a file: not ported yet (raises)."""
        raise NotImplementedError(_NO_FILES)


def load_topology(path: str) -> Topology:
    """Load atom attributes from a file: not ported yet (raises)."""
    raise NotImplementedError(_NO_FILES)


def read_pdb(path: str) -> System:
    """Read a PDB file: not ported yet (raises)."""
    raise NotImplementedError(_NO_FILES)


def read_gro(path: str) -> System:
    """Read a GRO file: not ported yet (raises)."""
    raise NotImplementedError(_NO_FILES)


def read_xyz(path: str) -> System:
    """Read an XYZ file: not ported yet (raises)."""
    raise NotImplementedError(_NO_FILES)


# =============================================================================
# Subsampling helper
# =============================================================================

def get_subsampled_indices(n_frames: int, times: Optional[np.ndarray] = None,
                           start=None, stop=None, step=None,
                           n_frames_out: Optional[int] = None) -> np.ndarray:
    """Regular-interval frame indices, by frame number or time.

    Reference behavior: upstream tfep/io/dataset/traj.py:549-645.

    Parameters
    ----------
    n_frames : int
        Total frames available.
    times : numpy.ndarray, optional
        ``(n_frames,)`` frame times in ps; required whenever any bound or
        step is given as a time ``Quantity``.
    start, stop : int or Quantity, optional
        Inclusive first/last frame. Time values snap inward (start rounds
        up to the first frame at/after it, stop rounds down).
    step : int or Quantity, optional
        Stride in frames, or a time interval matched against ``times``.
    n_frames_out : int, optional
        Instead of a stride, pick this many evenly-spaced frames
        (mutually exclusive with ``step``).

    Returns
    -------
    numpy.ndarray
        Sorted unique frame indices.
    """
    def to_frame(value, default, round_up):
        if value is None:
            return default
        if isinstance(value, Quantity):
            t = value.to(ureg.picosecond).magnitude
            if times is None:
                raise ValueError('Time-based subsampling requires times.')
            idx = (np.searchsorted(times, t, side='left') if round_up
                   else np.searchsorted(times, t, side='right') - 1)
            return int(np.clip(idx, 0, n_frames - 1))
        return int(value)

    start_f = to_frame(start, 0, round_up=True)
    stop_f = to_frame(stop, n_frames - 1, round_up=False)

    if n_frames_out is not None:
        if step is not None:
            raise ValueError('Pass either step or n_frames, not both.')
        return np.unique(np.linspace(start_f, stop_f, n_frames_out
                                     ).round().astype(np.int64))
    if step is None:
        step_f = 1
    elif isinstance(step, Quantity):
        dt = step.to(ureg.picosecond).magnitude
        if times is None:
            raise ValueError('Time-based subsampling requires times.')
        sel_times = np.arange(times[start_f], times[stop_f] + dt * 0.5, dt)
        # Guarantee the documented "sorted unique, in range" contract:
        # selection times past the last frame have no frame (dropping
        # them, not snapping to the end), and a step below the frame
        # spacing would repeat indices.
        sel_times = sel_times[sel_times <= times[stop_f] + 1e-9]
        return np.unique(np.searchsorted(times, sel_times - 1e-9))
    else:
        step_f = int(step)
    return np.arange(start_f, stop_f + 1, step_f, dtype=np.int64)


# =============================================================================
# Dataset
# =============================================================================

class Timestep:
    """One trajectory frame as a structured record.

    The native stand-in for MDAnalysis's ``Timestep`` in the dataset's
    frame-iteration API (:meth:`TrajectoryDataset.get_timestep` /
    :meth:`~TrajectoryDataset.iterate_as_timestep`; reference:
    upstream tfep/io/dataset/traj.py:226-293).

    Attributes
    ----------
    frame : int
        Absolute frame index in the underlying trajectory.
    positions : ndarray, shape (n_atoms, 3)
        Coordinates (angstrom) of the dataset's selected atoms.
    dimensions : ndarray or None
        Unit-cell ``[lx, ly, lz, alpha, beta, gamma]`` when the
        trajectory carries one.
    time : float or None
        Frame time in picoseconds when the trajectory carries times.
    """

    __slots__ = ('frame', 'positions', 'dimensions', 'time')

    def __init__(self, frame, positions, dimensions=None, time=None):
        self.frame = int(frame)
        self.positions = positions
        self.dimensions = dimensions
        self.time = time

    @property
    def n_atoms(self) -> int:
        """Number of atoms in this record."""
        return self.positions.shape[0]

    def __repr__(self):
        return (f'Timestep(frame={self.frame}, n_atoms={self.n_atoms}, '
                f'time={self.time})')


class TrajectoryDataset(Dataset):
    """Map-style dataset over a :class:`System`'s frames.

    Samples are dicts with ``positions`` flattened to ``(n_atoms*3,)`` in
    angstrom (float32, converted on access), optional ``dimensions`` box,
    registered auxiliary keys, and both dataset- and trajectory-frame
    indices for the TFEP logger addressing scheme.

    The two index keys differ once :meth:`subsample` has been applied:
    ``dataset_sample_index`` addresses the (possibly subsampled) dataset
    and is what samplers and loggers use within a run, while
    ``trajectory_sample_index`` is the absolute frame number in the
    underlying trajectory — stable across different subsamplings, which
    is why the TFEP logger and the Psi4 restart machinery key on it
    (reference: upstream tfep/io/dataset/traj.py:380-470).

    Auxiliary data registered with :meth:`add_aux` (e.g. PLUMED
    log-weights for biased simulations) is stored full-trajectory-length
    and indexed by trajectory frame, so it stays aligned under
    subsampling.
    """

    def __init__(self, system: System, return_dimensions: Optional[bool] = None):
        self.system = system
        self._frame_indices = np.arange(system.n_frames, dtype=np.int64)
        self._atom_indices: Optional[np.ndarray] = None
        if return_dimensions is None:
            return_dimensions = system.dimensions is not None
        self._return_dimensions = return_dimensions
        self._aux: Dict[str, np.ndarray] = {}

    # -- configuration -------------------------------------------------- #
    def select_atoms(self, selection) -> np.ndarray:
        """Restrict samples to the selected atoms; returns the indices."""
        self._atom_indices = self.system.select_atoms(selection)
        return self._atom_indices

    def subsample(self, start=None, stop=None, step=None, n_frames=None):
        """Keep a regular subset of frames (frame counts or time Quantities)."""
        idx = get_subsampled_indices(
            self.system.n_frames, times=self.system.times,
            start=start, stop=stop, step=step, n_frames_out=n_frames)
        self._frame_indices = self._frame_indices[
            np.isin(self._frame_indices, idx)]
        # Subsampling aux data must track the frames.
        return self._frame_indices

    def add_aux(self, name: str, values: Sequence):
        """Register per-frame auxiliary data (e.g. log-weights), full-traj length."""
        values = np.asarray(values)
        if len(values) != self.system.n_frames:
            raise ValueError(
                f'Auxiliary data {name!r} must have one entry per trajectory '
                f'frame ({self.system.n_frames}), got {len(values)}.')
        self._aux[name] = values

    # -- properties ----------------------------------------------------- #
    @property
    def n_atoms(self) -> int:
        if self._atom_indices is None:
            return self.system.n_atoms
        return len(self._atom_indices)

    @property
    def atom_indices(self) -> Optional[np.ndarray]:
        return self._atom_indices

    @property
    def trajectory_sample_indices(self) -> np.ndarray:
        return self._frame_indices

    # -- Dataset API ----------------------------------------------------- #
    def __len__(self):
        return len(self._frame_indices)

    def get_batch(self, indices):
        """Vectorized batch fetch: one coordinate read for all frames."""
        indices = np.asarray(indices, dtype=np.int64)
        frames = self._frame_indices[indices]
        positions = self.system.positions[frames]
        if self._atom_indices is not None:
            positions = positions[:, self._atom_indices]
        batch = {
            'positions': np.asarray(positions).reshape(
                len(indices), -1).astype(np.float64),
            'dataset_sample_index': indices,
            'trajectory_sample_index': frames,
        }
        if self._return_dimensions and self.system.dimensions is not None:
            batch['dimensions'] = self.system.dimensions[frames].astype(
                np.float64)
        for name, values in self._aux.items():
            batch[name] = np.asarray(values)[frames]
        return batch

    # -- Timestep iteration (reference API parity) ------------------------ #
    def get_timestep(self, index: int) -> 'Timestep':
        """The ``index``-th dataset sample as a :class:`Timestep` record.

        The native counterpart of the reference's MDAnalysis-Timestep
        accessor (upstream tfep/io/dataset/traj.py:226-272): frame
        subsampling and atom selection performed at the dataset level are
        honored, positions come back un-flattened ``(n_atoms, 3)``.
        """
        int_idx = int(index)
        frame = int(self._frame_indices[int_idx])
        positions = self.system.positions[frame]
        if self._atom_indices is not None:
            positions = positions[self._atom_indices]
        dimensions = (self.system.dimensions[frame]
                      if self.system.dimensions is not None else None)
        time = (float(self.system.times[frame])
                if self.system.times is not None else None)
        return Timestep(frame=frame, positions=np.asarray(positions),
                        dimensions=dimensions, time=time)

    def iterate_as_timestep(self):
        """Iterate the selected frames/atoms as :class:`Timestep` records.

        Iterating the dataset itself yields flattened training samples;
        this yields per-frame structured records instead — the equivalent
        of the reference's ``iterate_as_timestep``
        (upstream tfep/io/dataset/traj.py:274-293), e.g. for
        writing out the mapped/selected trajectory frame by frame.
        """
        for i in range(len(self)):
            yield self.get_timestep(i)

    def __getitem__(self, index):
        frame = int(self._frame_indices[index])
        pos = self.system.positions[frame]
        if self._atom_indices is not None:
            pos = pos[self._atom_indices]
        sample = {
            'positions': pos.reshape(-1).astype(np.float64),
            'dataset_sample_index': np.int64(index),
            'trajectory_sample_index': np.int64(frame),
        }
        if self._return_dimensions and self.system.dimensions is not None:
            sample['dimensions'] = self.system.dimensions[frame].astype(
                np.float64)
        for name, values in self._aux.items():
            sample[name] = values[frame]
        return sample
