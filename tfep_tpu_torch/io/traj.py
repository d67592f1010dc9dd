"""Trajectory readers and the trajectory dataset.

A copy of ``tfep_tpu/io/traj.py`` (numpy only, no JAX). Host-side
replacements for the MDAnalysis-backed data layer of the reference
(upstream tfep/io/dataset/traj.py:43-380). Multi-frame PDB (MODEL
records + CONECT bonds), GRO, and XYZ readers load frames into memory as
numpy; the binary formats (XTC/TRR/DCD/AMBER NetCDF) load eagerly or stream
through the lazy frame stores of :mod:`tfep_tpu_torch.io.frames`;
:class:`TrajectoryDataset` exposes dict samples
``{'positions' (n_atoms*3 flattened), 'dimensions' (box), 'dataset_sample_index',
'trajectory_sample_index', aux keys}`` with atom selection, frame subsampling
(by index or time), and auxiliary per-frame data (e.g. PLUMED log-weights).

Positions are in angstrom (PDB/XYZ native; GRO converted from nm).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Union

import numpy as np

from tfep_tpu_torch.io.dataset import Dataset
from tfep_tpu_torch.io.topology import Topology, _needs_coordinates
from tfep_tpu_torch.units import Quantity, ureg

__all__ = ['System', 'Timestep', 'TrajectoryDataset', 'read_pdb',
           'read_gro', 'read_xyz', 'get_subsampled_indices',
           'box_vectors_to_dimensions', 'dimensions_to_box_vectors']

#: Binary trajectory formats decodable frame-by-frame (lazy stores).
_BINARY_FORMATS = {'.dcd', '.xtc', '.trr', '.nc', '.ncdf'}

#: Single-frame AMBER restart formats (ASCII or NetCDF, sniffed by magic).
_RESTART_FORMATS = {'.inpcrd', '.rst7', '.restrt', '.ncrst'}


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
    frame times. ``positions`` may be an in-memory array or a lazy
    :class:`~tfep_tpu_torch.io.frames.FrameStore` — downstream code only relies
    on the array-like surface, so multi-gigabyte trajectories stream per
    batch without code changes.
    """

    def __init__(self, topology: Topology, positions,
                 dimensions: Optional[np.ndarray] = None,
                 times: Optional[np.ndarray] = None):
        """``positions``: (n_frames, n_atoms, 3) angstrom — an array or a
        lazy :class:`tfep_tpu_torch.io.frames.FrameStore`. ``dimensions``:
        (n_frames, 6) box [lx, ly, lz, alpha, beta, gamma] or None.
        ``times``: (n_frames,) ps or None (defaults to frame index)."""
        self.topology = topology
        if hasattr(positions, '_load_frames'):  # lazy frame store
            self.positions = positions
        else:
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
            # Only geometric selections read coordinates — plain attribute
            # selections must not force a frame decode on lazy FrameStores.
            positions = np.asarray(self.positions[frame])
            if self.dimensions is not None:
                dimensions = self.dimensions[frame]
        return self.topology.select_atoms(selection, positions=positions,
                                          dimensions=dimensions)

    @classmethod
    def from_file(cls, path: str, topology_path: Optional[str] = None,
                  lazy: bool = False) -> 'System':
        """Load from a trajectory file (PDB/GRO/XYZ/DCD/XTC/TRR/NetCDF, or
        a single-frame AMBER restart ``.inpcrd``/``.rst7``/``.restrt``/
        ``.ncrst``, by extension).

        Binary trajectory formats (DCD/XTC/TRR/AMBER ``.nc``) and restarts
        carry no topology: pass ``topology_path`` — a structure file
        (PDB/GRO) or a topology file (AMBER ``.prmtop``, GROMACS ``.top``,
        CHARMM/NAMD ``.psf``) — for the atom attributes.
        With ``lazy=True`` (binary formats only) coordinates stream from
        disk per batch through a :class:`~tfep_tpu_torch.io.frames.FrameStore`
        instead of loading the whole trajectory into memory.
        """
        readers = {'.pdb': read_pdb, '.gro': read_gro, '.xyz': read_xyz}
        ext = os.path.splitext(path)[1].lower()
        if ext in _RESTART_FORMATS:
            if topology_path is None:
                raise ValueError(
                    f'{ext} restart files require a topology_path '
                    '(PDB/GRO/prmtop/top/psf).')
            from tfep_tpu_torch.io.restart import read_amber_restart
            topology = load_topology(topology_path)
            positions, dimensions, times = read_amber_restart(path)
            if positions.shape[1] != topology.n_atoms:
                raise ValueError(
                    f'Restart has {positions.shape[1]} atoms but the '
                    f'topology has {topology.n_atoms}.')
            return cls(topology, positions, dimensions=dimensions,
                       times=None if times is None else np.asarray([times]))
        if ext in _BINARY_FORMATS:
            if topology_path is None:
                raise ValueError(
                    f'{ext} trajectories require a topology_path '
                    '(PDB/GRO/prmtop/top).')
            topology = load_topology(topology_path)
            from tfep_tpu_torch.io.frames import open_frame_store
            store = open_frame_store(path)
            if store.shape[1] != topology.n_atoms:
                raise ValueError(
                    f'Trajectory has {store.shape[1]} atoms but the '
                    f'topology has {topology.n_atoms}.')
            if lazy:
                return cls(topology, store,
                           dimensions=store.dimensions, times=store.times)
            return cls(topology, np.asarray(store),
                       dimensions=store.dimensions, times=store.times)
        if ext not in readers:
            raise ValueError(f'Unsupported trajectory format: {ext}')
        if lazy:
            raise ValueError(f'lazy=True requires a binary format '
                             f'({sorted(_BINARY_FORMATS)}), not {ext}.')
        return readers[ext](path)

    @classmethod
    def from_universe(cls, universe) -> 'System':
        """Build a :class:`System` from an MDAnalysis ``Universe``.

        Migration helper: users of the reference hold ``Universe`` objects
        (its ``TrajectoryDataset`` is built on one,
        upstream tfep/io/dataset/traj.py:43-120). The conversion is
        duck-typed — any object exposing ``.atoms`` (with per-atom
        attribute arrays), ``.trajectory`` (iterable of timesteps with
        ``positions``/``dimensions``/``time``), and optionally ``.bonds``
        works; MDAnalysis itself is not imported. Coordinates are read
        eagerly (MDAnalysis units are already angstrom/ps, matching the
        framework convention).
        """
        atoms = universe.atoms

        def attr(name):
            # MDAnalysis raises NoDataError for absent topology attributes.
            try:
                return np.asarray(getattr(atoms, name))
            except Exception:
                return None

        names = attr('names')
        if names is None:
            elements = attr('elements')
            if elements is not None:
                names = [f'{e}{i + 1}' for i, e in enumerate(elements)]
            else:
                names = [f'X{i + 1}' for i in range(len(atoms))]
        bonds = None
        try:
            bonds = np.asarray(universe.bonds.to_indices(), dtype=np.int64)
        except Exception:
            pass
        topology = Topology(
            names=names,
            elements=attr('elements'),
            resnames=attr('resnames'),
            resids=attr('resids'),
            masses=attr('masses'),
            bonds=bonds,
        )

        positions, dimensions, times = [], [], []
        for ts in universe.trajectory:
            # MDAnalysis readers reuse ONE Timestep object and mutate its
            # position buffer in place across iteration; a no-copy asarray
            # would alias every frame to the last one. Copy explicitly.
            positions.append(np.array(ts.positions, dtype=np.float32,
                                      copy=True))
            dims = getattr(ts, 'dimensions', None)
            # Older MDAnalysis returns zeros(6) instead of None for a
            # missing box, and some readers spell it [0, 0, 0, 90, 90, 90];
            # zero box lengths mean "no box" regardless of the angles.
            if dims is not None and not np.any(np.asarray(dims)[:3]):
                dims = None
            dimensions.append(None if dims is None
                              else np.array(dims, dtype=np.float32,
                                            copy=True))
            times.append(float(getattr(ts, 'time', len(times))))
        if not positions:
            raise ValueError('System.from_universe: universe.trajectory is '
                             'empty (no frames to read)')
        have_dims = [d for d in dimensions if d is not None]
        if have_dims and len(have_dims) != len(dimensions):
            raise ValueError(
                'System.from_universe: trajectory mixes frames with and '
                f'without box dimensions ({len(have_dims)}/{len(dimensions)} '
                'frames carry a box); refusing to silently drop the box')
        dims_arr = np.stack(dimensions) if have_dims else None
        return cls(topology, np.stack(positions), dimensions=dims_arr,
                   times=np.asarray(times, dtype=np.float64))

    def save(self, path: str, positions=None, **kwargs) -> None:
        """Write this system's frames (PDB/GRO/XYZ/XTC/TRR by extension).

        ``positions`` overrides the stored coordinates — pass the
        flow-mapped ensemble ``M(x)`` (flattened ``(n_frames, n_atoms*3)``
        accepted) to export it for engines/visualizers. See
        :func:`tfep_tpu_torch.io.writers.write_frames`.
        """
        from tfep_tpu_torch.io.writers import write_frames
        write_frames(path, self, positions=positions, **kwargs)


def load_topology(path: str) -> Topology:
    """Load atom attributes from a structure or topology file."""
    ext = os.path.splitext(path)[1].lower()
    if ext in ('.prmtop', '.parm7'):
        from tfep_tpu_torch.io.topfiles import read_prmtop
        return read_prmtop(path)
    if ext == '.top':
        from tfep_tpu_torch.io.topfiles import read_gromacs_top
        return read_gromacs_top(path)
    if ext == '.psf':
        from tfep_tpu_torch.io.topfiles import read_psf
        return read_psf(path)
    return System.from_file(path).topology


# =============================================================================
# Readers
# =============================================================================

def read_pdb(path: str) -> System:
    """Read a (multi-MODEL) PDB file.

    Parses ``ATOM``/``HETATM`` coordinates for every ``MODEL``, atom
    attributes from the first model, ``CONECT`` records into bonds, and a
    ``CRYST1`` record into per-frame unit-cell dimensions (PDB carries one
    box for all models). Element columns are honored when present,
    guessed from atom names otherwise.

    Parameters
    ----------
    path : str
        PDB file path.

    Returns
    -------
    System
        Coordinates in angstrom, one frame per MODEL.
    """
    frames = []
    names, resnames, resids, elements = [], [], [], []
    bonds = set()
    box = None
    current: list = []
    first_model_done = False

    with open(path) as f:
        for line in f:
            record = line[:6]
            if record in ('ATOM  ', 'HETATM'):
                x = float(line[30:38])
                y = float(line[38:46])
                z = float(line[46:54])
                current.append((x, y, z))
                if not first_model_done:
                    names.append(line[12:16].strip())
                    resnames.append(line[17:21].strip())
                    try:
                        resids.append(int(line[22:26]))
                    except ValueError:
                        resids.append(1)
                    elem = line[76:78].strip() if len(line) > 76 else ''
                    elements.append(elem if elem else None)
            elif record == 'CRYST1':
                box = [float(line[6:15]), float(line[15:24]),
                       float(line[24:33]), float(line[33:40]),
                       float(line[40:47]), float(line[47:54])]
            elif record.startswith('CONECT'):
                # Fixed 5-char serial columns (6:11, 11:16, ...): for
                # serials >= 10000 the fields abut with no separator, so
                # whitespace splitting silently drops or miswires bonds.
                fields = [line[start:start + 5].strip()
                          for start in range(6, min(len(line), 31), 5)]
                fields = [f for f in fields if f]
                if len(fields) >= 2:
                    a = int(fields[0]) - 1
                    for b_str in fields[1:]:
                        b = int(b_str) - 1
                        bonds.add((min(a, b), max(a, b)))
            elif record.startswith('ENDMDL') or record.startswith('END '):
                if current:
                    frames.append(current)
                    current = []
                    first_model_done = True
    if current:
        frames.append(current)

    if elements and all(e is None for e in elements):
        elements = None
    elif elements:
        elements = [e if e else None for e in elements]
        from tfep_tpu_torch.io.topology import guess_element
        elements = [e if e is not None else guess_element(n)
                    for e, n in zip(elements, names)]

    topology = Topology(names=names, elements=elements, resnames=resnames,
                        resids=resids, bonds=sorted(bonds))
    positions = np.asarray(frames, dtype=np.float32)
    dimensions = (None if box is None else
                  np.tile(np.asarray(box, np.float32), (len(frames), 1)))
    return System(topology, positions, dimensions)


def read_gro(path: str) -> System:
    """Read a GROMACS GRO file (single or concatenated frames).

    Coordinates are converted nm -> angstrom. The box line is parsed in
    both forms: 3 fields (orthorhombic diagonal) and 9 fields (full
    triclinic ``v1x v2y v3z v1y v1z v2x v2z v3x v3y``), the latter
    converted to lengths + angles — a triclinic box is never silently
    treated as rectangular.

    Parameters
    ----------
    path : str
        GRO file path.

    Returns
    -------
    System
        Coordinates in angstrom; atom attributes from the first frame.
    """
    frames, boxes = [], []
    names, resnames, resids = [], [], []
    first = True
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n_atoms = int(lines[i + 1])
        frame = []
        for j in range(n_atoms):
            line = lines[i + 2 + j]
            if first:
                resids.append(int(line[0:5]))
                resnames.append(line[5:10].strip())
                names.append(line[10:15].strip())
            frame.append((float(line[20:28]) * 10.0,
                          float(line[28:36]) * 10.0,
                          float(line[36:44]) * 10.0))
        box_fields = [float(x) * 10.0
                      for x in lines[i + 2 + n_atoms].split()]
        if len(box_fields) >= 9:
            # Triclinic: v1x v2y v3z v1y v1z v2x v2z v3x v3y (nm).
            f0 = box_fields
            vectors = np.asarray([[f0[0], f0[3], f0[4]],
                                  [f0[5], f0[1], f0[6]],
                                  [f0[7], f0[8], f0[2]]])
            boxes.append(box_vectors_to_dimensions(vectors))
        else:
            boxes.append([box_fields[0], box_fields[1], box_fields[2],
                          90.0, 90.0, 90.0])
        frames.append(frame)
        first = False
        i += 3 + n_atoms

    topology = Topology(names=names, resnames=resnames, resids=resids)
    return System(topology, np.asarray(frames, np.float32),
                  np.asarray(boxes, np.float32))


def read_xyz(path: str) -> System:
    """Read a (multi-frame) XYZ file.

    Parameters
    ----------
    path : str
        XYZ file path: per frame, an atom count line, a comment line,
        then ``element x y z`` rows in angstrom.

    Returns
    -------
    System
        Coordinates in angstrom; element symbols double as atom names.
    """
    frames, symbols = [], []
    first = True
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n_atoms = int(lines[i].strip())
        frame = []
        for j in range(n_atoms):
            fields = lines[i + 2 + j].split()
            if first:
                symbols.append(fields[0])
            frame.append(tuple(map(float, fields[1:4])))
        frames.append(frame)
        first = False
        i += 2 + n_atoms

    topology = Topology(names=symbols, elements=symbols)
    return System(topology, np.asarray(frames, np.float32))


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
        """Vectorized batch fetch: one coordinate read for all frames.

        With a lazy frame store this turns into a single native decode of
        the requested frames instead of one file access per sample.
        """
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
