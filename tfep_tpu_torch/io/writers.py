"""Trajectory writers: export a System (e.g. mapped configurations) to disk.

A copy of ``tfep_tpu/io/writers.py`` (numpy only, no JAX).

The reference delegates writing to MDAnalysis; here PDB/GRO/XYZ writers are
native and symmetric with the readers in :mod:`tfep_tpu_torch.io.traj` (round-trip
tested), and the binary XTC/TRR writers live in :mod:`tfep_tpu_torch.io.xdr`.
:func:`write_frames` dispatches on the file extension; ``System.save`` is
the object-level convenience. Typical use: write the flow-mapped ensemble
``M(x)`` so an external engine or visualizer can consume it.

All inputs are in the framework's native units (angstrom; dimensions as
``[lx, ly, lz, alpha, beta, gamma]`` with angles in degrees).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ['write_pdb', 'write_gro', 'write_xyz', 'write_frames']


def _frames_and_boxes(system, positions, dimensions):
    """Resolve (n_frames, n_atoms, 3) positions + per-frame dimensions.

    A 2D positions override is disambiguated against the topology: a
    ``(n_frames, n_atoms*3)`` array is the flow's flattened layout, a
    ``(n_atoms, 3)`` array a single frame (the ``System`` convention).
    """
    n_atoms = system.topology.n_atoms
    if positions is None:
        positions = system.positions[:]
    positions = np.asarray(positions, dtype=np.float64)
    if positions.ndim == 2:
        if positions.shape[1] == n_atoms * 3:
            positions = positions.reshape(positions.shape[0], n_atoms, 3)
        elif positions.shape == (n_atoms, 3):
            positions = positions[None]
        else:
            raise ValueError(
                f'2D positions must be ({n_atoms}, 3) (one frame) or '
                f'(n_frames, {n_atoms * 3}) (flattened); got '
                f'{positions.shape}.')
    if positions.shape[1:] != (n_atoms, 3):
        raise ValueError(
            f'positions shape {positions.shape} does not match the '
            f'topology ({n_atoms} atoms).')
    if dimensions is None:
        dimensions = system.dimensions
    if dimensions is not None:
        dimensions = np.asarray(dimensions, dtype=np.float64)
        if dimensions.ndim == 1:
            dimensions = np.tile(dimensions, (positions.shape[0], 1))
        elif dimensions.shape[0] == 1:
            # One box for the whole trajectory (e.g. a single-frame
            # structure file's CRYST1 paired with a mapped batch).
            dimensions = np.tile(dimensions, (positions.shape[0], 1))
        elif dimensions.shape[0] != positions.shape[0]:
            raise ValueError(
                f'{dimensions.shape[0]} boxes for {positions.shape[0]} '
                'frames; pass matching dimensions or a single box.')
    return positions, dimensions


def write_pdb(path: str, system, positions=None, dimensions=None) -> None:
    """Write a (multi-MODEL) PDB file.

    One ``MODEL``/``ENDMDL`` block per frame, a ``CRYST1`` record from the
    first frame's dimensions when present, element columns, and ``CONECT``
    records from the topology bonds (what :func:`tfep_tpu_torch.io.traj.read_pdb`
    reads back, and what :class:`tfep_tpu_torch.app.MixedMAFMap` needs to rebuild
    its Z-matrix from the file).

    Parameters
    ----------
    path : str
        Output path.
    system : System
        Supplies the topology, and positions/dimensions when not given.
    positions : array-like, optional
        ``(n_frames, n_atoms, 3)`` or flattened ``(n_frames, n_atoms*3)``
        angstrom override (e.g. mapped coordinates).
    dimensions : array-like, optional
        ``(n_frames, 6)`` or ``(6,)`` box override.
    """
    top = system.topology
    positions, dimensions = _frames_and_boxes(system, positions, dimensions)
    n_frames, n_atoms = positions.shape[:2]
    with open(path, 'w') as f:
        if dimensions is not None:
            lx, ly, lz, alpha, beta, gamma = dimensions[0]
            f.write(f'CRYST1{lx:9.3f}{ly:9.3f}{lz:9.3f}'
                    f'{alpha:7.2f}{beta:7.2f}{gamma:7.2f} P 1           1\n')
        for frame_idx in range(n_frames):
            f.write(f'MODEL     {frame_idx + 1:4d}\n')
            for i in range(n_atoms):
                x, y, z = positions[frame_idx, i]
                name = str(top.names[i])[:4]
                # PDB name column convention: 1-3 char names start at col 14.
                name_field = f' {name:<3s}' if len(name) < 4 else name
                resname = str(top.resnames[i])[:4]
                resid = int(top.resids[i]) % 10000
                element = str(top.elements[i])[:2].rjust(2)
                # Columns (0-indexed): serial 6:11, name 12:16, altLoc 16,
                # resName 17:21, resSeq 22:26, xyz 30:54, element 76:78 —
                # matching read_pdb and the PDB standard.
                f.write(f'ATOM  {(i + 1) % 100000:5d} {name_field:<4s} '
                        f'{resname:<4s} {resid:4d}    '
                        f'{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}'
                        f'          {element}\n')
            f.write('ENDMDL\n')
        # CONECT records once, after the coordinate blocks. The fixed
        # 5-column serial field cannot represent atoms >= 100000, so bonds
        # are omitted (not wrapped into colliding serials) beyond that.
        if n_atoms < 100000:
            neighbors: dict = {}
            for a, b in np.asarray(top.bonds).reshape(-1, 2) \
                    if len(top.bonds) else []:
                neighbors.setdefault(int(a), []).append(int(b))
                neighbors.setdefault(int(b), []).append(int(a))
            for a in sorted(neighbors):
                for chunk_start in range(0, len(neighbors[a]), 4):
                    chunk = neighbors[a][chunk_start:chunk_start + 4]
                    f.write('CONECT' + f'{a + 1:5d}'
                            + ''.join(f'{b + 1:5d}' for b in sorted(chunk))
                            + '\n')
        f.write('END\n')


def write_gro(path: str, system, positions=None, dimensions=None,
              title: str = 'tfep_tpu') -> None:
    """Write a GROMACS GRO file (frames concatenated).

    Coordinates are converted angstrom -> nm. Orthorhombic boxes produce
    the 3-field box line; triclinic boxes the full 9-field form (so the
    reader's triclinic handling round-trips). Without dimensions a zero
    box line is written.

    Parameters are as in :func:`write_pdb`.
    """
    top = system.topology
    positions, dimensions = _frames_and_boxes(system, positions, dimensions)
    n_frames, n_atoms = positions.shape[:2]
    from tfep_tpu_torch.io.traj import dimensions_to_box_vectors

    with open(path, 'w') as f:
        for frame_idx in range(n_frames):
            f.write(f'{title}, frame {frame_idx}\n{n_atoms:5d}\n')
            for i in range(n_atoms):
                x, y, z = positions[frame_idx, i] / 10.0
                resid = int(top.resids[i]) % 100000
                f.write(f'{resid:5d}{str(top.resnames[i])[:5]:<5s}'
                        f'{str(top.names[i])[:5]:>5s}{(i + 1) % 100000:5d}'
                        f'{x:8.3f}{y:8.3f}{z:8.3f}\n')
            if dimensions is None:
                f.write(f'{0.0:10.5f}{0.0:10.5f}{0.0:10.5f}\n')
            else:
                dims = dimensions[frame_idx]
                if np.allclose(dims[3:], 90.0):
                    lx, ly, lz = dims[:3] / 10.0
                    f.write(f'{lx:10.5f}{ly:10.5f}{lz:10.5f}\n')
                else:
                    v = dimensions_to_box_vectors(dims) / 10.0
                    fields = [v[0, 0], v[1, 1], v[2, 2], v[0, 1], v[0, 2],
                              v[1, 0], v[1, 2], v[2, 0], v[2, 1]]
                    f.write(''.join(f'{x:10.5f}' for x in fields) + '\n')


def write_xyz(path: str, system, positions=None, comment: str = '') -> None:
    """Write a (multi-frame) XYZ file: element symbol + angstrom coords."""
    top = system.topology
    positions, _ = _frames_and_boxes(system, positions, None)
    n_frames, n_atoms = positions.shape[:2]
    with open(path, 'w') as f:
        for frame_idx in range(n_frames):
            f.write(f'{n_atoms}\n{comment or f"frame {frame_idx}"}\n')
            for i in range(n_atoms):
                x, y, z = positions[frame_idx, i]
                f.write(f'{str(top.elements[i]):<3s} '
                        f'{x:14.8f} {y:14.8f} {z:14.8f}\n')


def write_frames(path: str, system, positions=None, dimensions=None,
                 **kwargs) -> None:
    """Write frames in the format implied by the file extension.

    Supports ``.pdb``, ``.gro``, ``.xyz`` (native text writers here),
    ``.xtc``/``.trr`` (binary, via :mod:`tfep_tpu_torch.io.xdr`; positions
    converted angstrom -> nm), and AMBER ``.nc``/``.ncdf`` (via
    :mod:`tfep_tpu_torch.io.netcdf`; angstrom natively).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == '.pdb':
        return write_pdb(path, system, positions, dimensions, **kwargs)
    if ext == '.gro':
        return write_gro(path, system, positions, dimensions, **kwargs)
    if ext == '.xyz':
        return write_xyz(path, system, positions, **kwargs)
    if ext in ('.xtc', '.trr'):
        from tfep_tpu_torch.io.traj import dimensions_to_box_vectors
        from tfep_tpu_torch.io.xdr import write_trr, write_xtc

        positions, dimensions = _frames_and_boxes(
            system, positions, dimensions)
        positions_nm = positions / 10.0
        boxes_nm = (None if dimensions is None
                    else dimensions_to_box_vectors(dimensions) / 10.0)
        writer = write_xtc if ext == '.xtc' else write_trr
        return writer(path, positions_nm, boxes_nm=boxes_nm, **kwargs)
    if ext in ('.nc', '.ncdf'):
        from tfep_tpu_torch.io.netcdf import write_amber_netcdf

        positions, dimensions = _frames_and_boxes(
            system, positions, dimensions)
        times = getattr(system, 'times', None)
        return write_amber_netcdf(path, positions, times=times,
                                  dimensions=dimensions, **kwargs)
    raise ValueError(f'Unsupported trajectory format: {ext}')
