"""AMBER restart/coordinate readers: ASCII ``inpcrd``/``rst7`` and NetCDF
restart (``ncrst``).

A copy of ``tfep_tpu/io/restart.py`` (numpy only, no JAX).

AMBER workflows start from (and checkpoint to) single-frame restart files;
both flavors pair with the ``.prmtop`` topology this package parses
natively (:func:`tfep_tpu_torch.io.topfiles.read_prmtop`), completing the AMBER
input path next to the multi-frame NetCDF trajectories
(:mod:`tfep_tpu_torch.io.netcdf`). The reference accepts them through MDAnalysis
(upstream tfep/io/dataset/traj.py:43-120).

Both flavors share the ``.rst7``/``.restrt`` extensions in the wild, so
:func:`read_amber_restart` sniffs the NetCDF magic (``CDF``) and
dispatches; the published formats implemented are

- ASCII (AMBER "inpcrd/restrt format"): a title line; a line with the atom
  count and optionally the time in ps; coordinates as fixed-width
  ``6F12.7`` fields in angstrom; then optionally velocities (same layout)
  and/or one final ``6F12.7`` line with the periodic box
  (lengths + angles). Which trailing blocks are present is determined by
  the leftover value count (0, 6, 3N, or 3N+6) — the same disambiguation
  every AMBER reader uses.
- NetCDF (AMBER NetCDF restart convention): a classic-format file with
  ``Conventions = "AMBERRESTART"`` whose ``coordinates(atom, spatial)``
  variable is a *non-record* double in angstrom, with optional scalar
  ``time`` and non-record ``cell_lengths``/``cell_angles``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ['read_amber_restart', 'read_inpcrd', 'read_ncrst']

#: (positions (1, n, 3) angstrom, dimensions (1, 6) or None, time ps or None)
RestartData = Tuple[np.ndarray, Optional[np.ndarray], Optional[float]]


def read_amber_restart(path: str) -> RestartData:
    """Read an AMBER restart file, ASCII or NetCDF (sniffed by magic).

    Returns
    -------
    positions : numpy.ndarray
        ``(1, n_atoms, 3)`` in angstrom (one frame).
    dimensions : numpy.ndarray or None
        ``(1, 6)`` unit cell ``[lx, ly, lz, alpha, beta, gamma]``
        (angstrom/degrees) when the file carries a box.
    time : float or None
        Restart time in ps when recorded.
    """
    with open(path, 'rb') as f:
        magic = f.read(3)
    if magic == b'CDF' or magic[:2] == b'\x89H':
        return read_ncrst(path)
    return read_inpcrd(path)


def read_inpcrd(path: str) -> RestartData:
    """Read an ASCII AMBER ``inpcrd``/``restrt`` file (see module docs)."""
    with open(path) as f:
        f.readline()                                    # title
        count_line = f.readline().split()
        if not count_line:
            raise ValueError(f'{path}: missing atom-count line.')
        n_atoms = int(count_line[0])
        time = float(count_line[1]) if len(count_line) > 1 else None
        values = []
        for line in f:
            # Fixed-width 12-char fields (%12.7f): whitespace splitting
            # would mis-parse fields that run together at large negative
            # coordinates, so slice.
            line = line.rstrip('\n')
            row = [line[k:k + 12] for k in range(0, len(line), 12)]
            values.extend(float(x) for x in row if x.strip())

    n_coords = 3 * n_atoms
    if len(values) < n_coords:
        raise ValueError(
            f'{path}: expected {n_coords} coordinate values for '
            f'{n_atoms} atoms, found {len(values)}.')
    positions = np.asarray(values[:n_coords],
                           dtype=np.float64).reshape(1, n_atoms, 3)

    rest = values[n_coords:]
    dimensions = None
    if len(rest) == 0:
        pass
    elif len(rest) == 6 and n_coords == 6:
        # 2-atom file: 6 trailing values are genuinely ambiguous in the
        # ASCII format (velocities and a box line are indistinguishable).
        # Use the established disambiguation heuristic (cf. ParmEd's rst7
        # reader): a box has positive lengths and angles in (0, 180].
        lengths, angles = rest[:3], rest[3:]
        if all(v > 0 for v in lengths) and all(0 < a <= 180
                                               for a in angles):
            dimensions = np.asarray(rest, dtype=np.float64).reshape(1, 6)
        # else: velocities — dropped, like the unambiguous case below.
    elif len(rest) == 6:                                # box only
        dimensions = np.asarray(rest, dtype=np.float64).reshape(1, 6)
    elif len(rest) == n_coords:                         # velocities only
        pass
    elif len(rest) == n_coords + 6:                     # velocities + box
        dimensions = np.asarray(rest[n_coords:],
                                dtype=np.float64).reshape(1, 6)
    else:
        raise ValueError(
            f'{path}: {len(rest)} trailing values after the coordinates '
            f'fit neither velocities (3N={n_coords}), a box (6), nor '
            'both.')
    return positions.astype(np.float32), \
        (None if dimensions is None else dimensions.astype(np.float32)), \
        time


def read_ncrst(path: str) -> RestartData:
    """Read an AMBER NetCDF restart (``AMBERRESTART`` convention)."""
    from tfep_tpu_torch.io.netcdf import NetCDFFile

    nc = NetCDFFile.open(path)
    conventions = str(nc.attrs.get('Conventions', ''))
    if 'AMBERRESTART' not in conventions:
        raise ValueError(
            f'{path}: Conventions={conventions!r} is not an AMBER NetCDF '
            'restart (use tfep_tpu_torch.io.netcdf for trajectories).')
    if 'coordinates' not in nc.variables:
        raise ValueError(f'{path}: no coordinates variable.')
    coords = nc.variables['coordinates']
    if coords.is_record or len(coords.shape) != 2 or coords.shape[1] != 3:
        raise ValueError(
            f'{path}: restart coordinates must be a non-record '
            f'(atom, 3) variable, got shape {coords.shape} '
            f'(record={coords.is_record}).')
    units = str(coords.attrs.get('units', 'angstrom')).lower()
    if units not in ('angstrom', 'angstroms'):
        raise ValueError(f'{path}: coordinates units {units!r} not '
                         'supported (the convention mandates angstrom).')

    positions = nc.read('coordinates').astype(np.float64)
    positions *= float(coords.attrs.get('scale_factor', 1.0))
    positions = positions[None, :, :]

    dimensions = None
    if 'cell_lengths' in nc.variables and 'cell_angles' in nc.variables:
        lengths = nc.read('cell_lengths').astype(np.float64)
        angles = nc.read('cell_angles').astype(np.float64)
        lengths *= float(
            nc.variables['cell_lengths'].attrs.get('scale_factor', 1.0))
        angles *= float(
            nc.variables['cell_angles'].attrs.get('scale_factor', 1.0))
        if np.abs(lengths).max() > 0:
            dimensions = np.concatenate([lengths, angles])[None, :]

    time = None
    if 'time' in nc.variables:
        time_value = nc.read('time').astype(np.float64).reshape(-1)
        if time_value.size:
            time = float(time_value[0] * float(
                nc.variables['time'].attrs.get('scale_factor', 1.0)))

    return positions.astype(np.float32), \
        (None if dimensions is None else dimensions.astype(np.float32)), \
        time
