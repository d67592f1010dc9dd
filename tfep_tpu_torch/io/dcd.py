"""DCD binary trajectory reader (native C++ fast path + Python fallback).

A copy of ``tfep_tpu/io/dcd.py`` (numpy only, no JAX).

The native decoder (tfep_tpu_torch/native/trajio.cpp, loaded via
:mod:`tfep_tpu_torch.io.native`) is the production path; a pure-Python
struct-based reader handles the same format when no compiler is available.
``read_dcd`` returns a :class:`tfep_tpu_torch.io.traj.System`-compatible payload
(positions in angstrom, optional unit cells).
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

from tfep_tpu_torch.io.native import native_available, native_lib as _native_lib

__all__ = ['read_dcd_header', 'read_dcd', 'read_dcd_cells',
           'native_available']


# =============================================================================
# Pure-Python fallback
# =============================================================================

def _py_parse_header(f):
    try:
        return _py_parse_header_impl(f)
    except struct.error as err:
        # A truncated file makes f.read() come up short and struct raise
        # its own error type; callers (and the native-failure fallback in
        # read_dcd_header) expect the parser's ValueError contract.
        raise ValueError(f'Truncated or corrupt DCD header: {err}') from err


def _py_parse_header_impl(f):
    marker = struct.unpack('<i', f.read(4))[0]
    if marker != 84:
        raise ValueError('Not a DCD file (bad header record length).')
    if f.read(4) != b'CORD':
        raise ValueError('Not a DCD file (missing CORD magic).')
    icntrl = struct.unpack('<20i', f.read(80))
    if struct.unpack('<i', f.read(4))[0] != 84:
        raise ValueError('Corrupt DCD header.')
    if icntrl[8] != 0:
        # Fixed-atom DCDs store only the free atoms (plus an index record)
        # for frames after the first; the uniform frame-size assumption
        # below would silently decode shifted garbage.
        raise ValueError(
            f'DCD file uses fixed atoms (NAMNF={icntrl[8]}), which this '
            'reader does not support; rewrite the trajectory with all '
            'atoms free.')

    has_cell = icntrl[10] != 0
    title_len = struct.unpack('<i', f.read(4))[0]
    f.seek(title_len, os.SEEK_CUR)
    f.read(4)
    if struct.unpack('<i', f.read(4))[0] != 4:
        raise ValueError('Corrupt DCD atom record.')
    n_atoms = struct.unpack('<i', f.read(4))[0]
    f.read(4)

    first_offset = f.tell()
    coord_record = 8 + 4 * n_atoms
    frame_size = 3 * coord_record + (56 if has_cell else 0)
    f.seek(0, os.SEEK_END)
    n_frames = (f.tell() - first_offset) // frame_size
    if icntrl[0] > 0:
        n_frames = min(n_frames, icntrl[0])
    return n_frames, n_atoms, has_cell, first_offset, frame_size


def _unscramble_cell(record):
    """DCD cell record order (A, gamma, B, beta, alpha, C) ->
    [lx, ly, lz, alpha, beta, gamma]."""
    return [record[0], record[2], record[5],
            record[4], record[3], record[1]]


def _normalize_cell_angles(cells):
    """Convert CHARMM cosine-convention cell angles to degrees in place.

    CHARMM (c22+) stores cos(angle) in the three angle slots; X-PLOR and
    NAMD store degrees. The standard disambiguation (as in MDAnalysis):
    when all three angle values lie within [-1, 1], they are cosines.
    """
    if cells is None:
        return None
    angles = cells[..., 3:]
    are_cosines = np.all(np.abs(angles) <= 1.0, axis=-1, keepdims=True)
    degrees = np.degrees(np.arccos(np.clip(angles, -1.0, 1.0)))
    cells[..., 3:] = np.where(are_cosines, degrees, angles)
    return cells


def _py_read_frames(path, frame_indices):
    with open(path, 'rb') as f:
        n_frames, n_atoms, has_cell, first_offset, frame_size = \
            _py_parse_header(f)
        positions = np.empty((len(frame_indices), n_atoms, 3),
                             dtype=np.float32)
        cells = (np.empty((len(frame_indices), 6)) if has_cell else None)
        for i, frame in enumerate(frame_indices):
            if not 0 <= frame < n_frames:
                raise IndexError(f'Frame {frame} out of range.')
            f.seek(first_offset + frame * frame_size)
            if has_cell:
                f.read(4)
                cell = struct.unpack('<6d', f.read(48))
                f.read(4)
                cells[i] = _unscramble_cell(cell)
            for dim in range(3):
                f.read(4)
                positions[i, :, dim] = np.frombuffer(
                    f.read(4 * n_atoms), dtype='<f4')
                f.read(4)
    return positions, cells


# =============================================================================
# Public API
# =============================================================================

def read_dcd_header(path: str) -> Tuple[int, int, bool]:
    """Return (n_frames, n_atoms, has_cell)."""
    lib = _native_lib()
    if lib is not None:
        out = (ctypes.c_int64 * 3)()
        status = lib.dcd_read_header(path.encode(), out)
        if status != 0:
            # Re-parse in Python for a specific message (e.g. fixed atoms).
            with open(path, 'rb') as f:
                _py_parse_header(f)
            raise ValueError(f'Failed to parse DCD header ({status}).')
        return int(out[0]), int(out[1]), bool(out[2])
    with open(path, 'rb') as f:
        n_frames, n_atoms, has_cell, _, _ = _py_parse_header(f)
    return n_frames, n_atoms, has_cell


def read_dcd_cells(path: str) -> Optional[np.ndarray]:
    """Seek-read every frame's unit cell without decoding coordinates.

    Returns (n_frames, 6) ``[lx, ly, lz, alpha, beta, gamma]`` (degrees),
    or ``None`` when the file carries no cell records.
    """
    with open(path, 'rb') as f:
        n_frames, _, has_cell, first_offset, frame_size = _py_parse_header(f)
        if not has_cell:
            return None
        cells = np.empty((n_frames, 6))
        for i in range(n_frames):
            f.seek(first_offset + i * frame_size + 4)
            cells[i] = _unscramble_cell(struct.unpack('<6d', f.read(48)))
    return _normalize_cell_angles(cells)


def read_dcd(path: str, frame_indices: Optional[Sequence[int]] = None
             ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read frames from a DCD file.

    Returns ``(positions, cells)``: positions (n_frames, n_atoms, 3)
    float32 angstrom; cells (n_frames, 6) [lx, ly, lz, alpha, beta, gamma]
    or None.
    """
    n_frames, n_atoms, has_cell = read_dcd_header(path)
    if frame_indices is None:
        frame_indices = np.arange(n_frames, dtype=np.int64)
    else:
        # The native decoder reads consecutive int64s through a raw
        # pointer: a strided view (e.g. arange(10)[::2]) must be copied
        # contiguous or the wrong frames are read silently.
        frame_indices = np.ascontiguousarray(frame_indices, dtype=np.int64)

    lib = _native_lib()
    if lib is None:
        positions, cells = _py_read_frames(path, frame_indices)
        return positions, _normalize_cell_angles(cells)

    positions = np.empty((len(frame_indices), n_atoms, 3), dtype=np.float32)
    cells = np.empty((len(frame_indices), 6)) if has_cell else None
    status = lib.dcd_read_frames(
        path.encode(),
        frame_indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(frame_indices),
        positions.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        (cells.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
         if cells is not None else None))
    if status != 0:
        raise ValueError(f'Failed to read DCD frames ({status}).')
    return positions, _normalize_cell_angles(cells)
