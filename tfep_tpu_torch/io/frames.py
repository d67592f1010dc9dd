"""Lazy frame stores: random-access trajectory coordinates without
loading the file into memory.

A copy of ``tfep_tpu/io/frames.py`` (numpy only, no JAX).

A frame store quacks like the ``(n_frames, n_atoms, 3)`` position array a
:class:`tfep_tpu_torch.io.traj.System` holds — ``.shape``, ``len()``, and
``store[frame] -> (n_atoms, 3)`` — but decodes frames on demand (native
C++ decoders when available) behind a small LRU cache. Box dimensions and
times are read eagerly at open (they live in plain frame headers; no
decompression needed), so dataset construction stays cheap while
multi-gigabyte coordinate payloads stream per batch.

This is the streaming data layer the reference gets from MDAnalysis
iterators (upstream tfep/io/dataset/traj.py:274).
"""

from __future__ import annotations

import ctypes
import os
import struct
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from tfep_tpu_torch.io.native import native_lib

__all__ = ['FrameStore', 'XtcFrameStore', 'TrrFrameStore', 'DcdFrameStore',
           'NetCDFFrameStore', 'open_frame_store']

_NM_TO_ANGSTROM = 10.0


class FrameStore:
    """Base class: lazy ``(n_frames, n_atoms, 3)`` coordinate access.

    Subclasses implement :meth:`_load_frames` (decode a list of frame
    indices into an angstrom float32 array); this base provides the
    array-like surface — ``.shape``/``.ndim``/``len()``, integer indexing
    through an LRU cache of :attr:`CACHE_FRAMES` decoded frames, fancy
    indexing that bypasses the cache (batch reads are assumed
    non-repeating), and ``__array__`` so ``np.asarray(store)`` eagerly
    materializes the whole trajectory when a caller really wants that.

    The cache is not locked: only integer indexing touches it, and the
    trainer's prefetch thread reads batches by fancy indexing
    (:meth:`~tfep_tpu_torch.io.traj.TrajectoryDataset.get_batch`), so it
    stays on the thread that indexes single frames.

    Integer indexing returns ``(n_atoms, 3)``; slice or fancy indexing
    returns ``(n_selected, n_atoms, 3)``. All coordinates are angstrom,
    the framework-wide unit convention (matching MDAnalysis, which the
    reference relies on).
    """

    #: Decoded frames kept in memory (LRU). Batches revisit frames within
    #: an epoch only under shuffling, so a modest cache suffices.
    CACHE_FRAMES = 256

    def __init__(self, path: str, n_frames: int, n_atoms: int):
        self.path = path
        self._shape = (n_frames, n_atoms, 3)
        self._cache: OrderedDict = OrderedDict()

    # -- array-like surface -------------------------------------------- #
    @property
    def shape(self) -> Tuple[int, int, int]:
        return self._shape

    @property
    def ndim(self) -> int:
        return 3

    def __len__(self) -> int:
        return self._shape[0]

    def __getitem__(self, frame_idx):
        if isinstance(frame_idx, (int, np.integer)):
            frame_idx = int(frame_idx)
            if frame_idx < 0:
                frame_idx += len(self)
            if frame_idx in self._cache:
                self._cache.move_to_end(frame_idx)
                return self._cache[frame_idx]
            frame = self._load_frames([frame_idx])[0]
            self._cache[frame_idx] = frame
            if len(self._cache) > self.CACHE_FRAMES:
                self._cache.popitem(last=False)
            return frame
        # Fancy/slice indexing decodes without touching the cache.
        indices = np.arange(len(self))[frame_idx]
        return self._load_frames(list(np.atleast_1d(indices)))

    def __array__(self, dtype=None, copy=None):
        full = self._load_frames(list(range(len(self))))
        return full if dtype is None else full.astype(dtype)

    # -- subclass interface --------------------------------------------- #
    def _load_frames(self, frame_indices) -> np.ndarray:
        """Decode frames -> (len(frame_indices), n_atoms, 3) angstrom."""
        raise NotImplementedError


class _XdrFrameStore(FrameStore):
    """Shared machinery for the native-decoded XTC/TRR stores."""

    def _frame_chunk(self, f, frame_offset: int, offsets=None) -> bytes:
        """Read exactly one frame's bytes (offset to the next frame).

        Keeps the pure-Python fallback streaming too: per-batch I/O stays
        O(frames requested), not O(file size). ``offsets`` must be passed
        explicitly during ``_scan`` (before ``self._offsets`` exists).
        """
        if offsets is None:
            offsets = self._offsets
        idx = int(np.searchsorted(offsets, frame_offset))
        end = (int(offsets[idx + 1]) if idx + 1 < len(offsets)
               else os.fstat(f.fileno()).st_size)
        f.seek(frame_offset)
        return f.read(end - frame_offset)

    _SCAN = ''          # native scan symbol
    _READ = ''          # native read symbol
    _MAGIC = 0

    def __init__(self, path: str):
        offsets, n_atoms, boxes_nm, times = self._scan(path)
        super().__init__(path, len(offsets), n_atoms)
        self._offsets = offsets
        self.dimensions = self._boxes_to_dimensions(boxes_nm)
        self.times = times

    # -- header pass ---------------------------------------------------- #
    def _scan(self, path):
        lib = native_lib()
        if lib is not None:
            info = (ctypes.c_int64 * 2)()
            status = getattr(lib, self._SCAN)(path.encode(), None, 0, info)
            if status != 0:
                raise ValueError(f'Failed to scan {path} ({status}).')
            n_frames = int(info[0])
            offsets = np.zeros(n_frames, dtype=np.int64)
            status = getattr(lib, self._SCAN)(
                path.encode(),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                n_frames, info)
            if status != 0:
                # A failure here (file truncated/replaced between the two
                # scans) would otherwise leave all-zero offsets and decode
                # frame 0 for every request.
                raise ValueError(f'Failed to scan {path} ({status}).')
            n_atoms = int(info[1])
        else:
            offsets, n_atoms = self._py_scan(path)
        boxes, times = self._read_headers(path, offsets)
        return offsets, n_atoms, boxes, times

    @staticmethod
    def _boxes_to_dimensions(boxes_nm: Optional[np.ndarray]):
        if boxes_nm is None or not len(boxes_nm) \
                or not np.abs(boxes_nm).max() > 0:
            return None
        from tfep_tpu_torch.io.traj import box_vectors_to_dimensions
        return box_vectors_to_dimensions(boxes_nm * _NM_TO_ANGSTROM)

    # -- decode --------------------------------------------------------- #
    def _load_frames(self, frame_indices) -> np.ndarray:
        n = len(frame_indices)
        n_atoms = self.shape[1]
        offsets = self._offsets[np.asarray(frame_indices, dtype=np.int64)]
        offsets = np.ascontiguousarray(offsets)
        lib = native_lib()
        if lib is None:
            return self._py_load(offsets)
        positions = np.empty((n, n_atoms, 3), dtype=np.float32)
        status = getattr(lib, self._READ)(
            self.path.encode(),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, n_atoms,
            positions.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            None, None)
        if status != 0:
            raise ValueError(f'Failed to decode {self.path} ({status}).')
        return positions * np.float32(_NM_TO_ANGSTROM)

    # -- pure-Python fallbacks ------------------------------------------ #
    def _py_scan(self, path):
        raise NotImplementedError

    def _py_load(self, offsets):
        raise NotImplementedError

    def _read_headers(self, path, offsets):
        raise NotImplementedError


class XtcFrameStore(_XdrFrameStore):
    """Lazy XTC coordinates; boxes/times read from plain headers."""

    _SCAN = 'xtc_scan'
    _READ = 'xtc_read_frames'

    def _py_scan(self, path):
        from tfep_tpu_torch.io.xdr import scan_xtc_offsets
        return scan_xtc_offsets(path)

    def _py_load(self, offsets):
        from tfep_tpu_torch.io.xdr import _decompress_coords
        frames = []
        with open(self.path, 'rb') as f:
            for off in offsets:
                chunk = self._frame_chunk(f, int(off))
                frames.append(
                    _decompress_coords(chunk, 56, self.shape[1])[0])
        return np.asarray(frames, dtype=np.float32) * _NM_TO_ANGSTROM

    def _read_headers(self, path, offsets):
        boxes = np.empty((len(offsets), 3, 3))
        times = np.empty(len(offsets))
        with open(path, 'rb') as f:
            for i, off in enumerate(offsets):
                f.seek(int(off) + 12)
                raw = f.read(40)
                times[i] = struct.unpack('>f', raw[:4])[0]
                boxes[i] = np.asarray(
                    struct.unpack('>9f', raw[4:])).reshape(3, 3)
        return boxes, times


class TrrFrameStore(_XdrFrameStore):
    """Lazy TRR coordinates; boxes/times read from plain headers."""

    _SCAN = 'trr_scan'
    _READ = 'trr_read_frames'

    def _py_scan(self, path):
        from tfep_tpu_torch.io.xdr import scan_trr_offsets
        return scan_trr_offsets(path)

    def _py_load(self, offsets):
        from tfep_tpu_torch.io.xdr import _read_trr_frame
        frames = []
        with open(self.path, 'rb') as f:
            for off in offsets:
                chunk = self._frame_chunk(f, int(off))
                frames.append(_read_trr_frame(chunk, 0)[0])
        return np.asarray(frames, dtype=np.float32) * _NM_TO_ANGSTROM

    def _read_headers(self, path, offsets):
        from tfep_tpu_torch.io.xdr import _read_trr_frame
        boxes, times = [], []
        with open(path, 'rb') as f:
            for off in offsets:
                chunk = self._frame_chunk(f, int(off), offsets)
                _, _, _, box, time, _, _ = _read_trr_frame(chunk, 0)
                boxes.append(box)
                times.append(time)
        if any(b is None for b in boxes):
            return None, np.asarray(times)
        return np.asarray(boxes), np.asarray(times)


class DcdFrameStore(FrameStore):
    """Lazy DCD coordinates (already angstrom); cells read at open."""

    def __init__(self, path: str):
        from tfep_tpu_torch.io.dcd import read_dcd_cells, read_dcd_header
        n_frames, n_atoms, has_cell = read_dcd_header(path)
        super().__init__(path, n_frames, n_atoms)
        self.times = np.arange(n_frames, dtype=np.float64)
        # Cells sit in fixed-size records at the head of each frame;
        # read_dcd_cells seek-reads them (shared record layout + CHARMM
        # cosine-angle handling) without decoding any coordinates.
        self.dimensions = read_dcd_cells(path) if has_cell else None

    def _load_frames(self, frame_indices) -> np.ndarray:
        from tfep_tpu_torch.io.dcd import read_dcd
        positions, _ = read_dcd(self.path, frame_indices)
        return positions


class NetCDFFrameStore(FrameStore):
    """Lazy AMBER NetCDF (.nc) coordinates; cells/times read at open.

    The commonly-paired trajectory format for ``.prmtop`` topologies
    (tfep_tpu_torch.io.topfiles.read_prmtop). The AMBER convention stores
    coordinates in angstrom and times in ps — already the framework
    units — as float32 record variables, so per-frame reads are single
    seeks with stride ``recsize`` (tfep_tpu_torch/io/netcdf.py). The optional
    per-variable ``scale_factor`` attribute is applied on read.
    """

    def __init__(self, path: str):
        from tfep_tpu_torch.io.netcdf import read_amber_netcdf_header
        self._nc = read_amber_netcdf_header(path)
        coords = self._nc.variables['coordinates']
        n_frames, n_atoms, _ = coords.shape
        super().__init__(path, n_frames, n_atoms)
        self._scale = float(coords.attrs.get('scale_factor', 1.0))

        if 'time' in self._nc.variables:
            times = self._nc.read('time').astype(np.float64)
            times *= float(
                self._nc.variables['time'].attrs.get('scale_factor', 1.0))
            self.times = times
        else:
            self.times = np.arange(n_frames, dtype=np.float64)

        self.dimensions = None
        if ('cell_lengths' in self._nc.variables
                and 'cell_angles' in self._nc.variables):
            lengths = self._nc.read('cell_lengths').astype(np.float64)
            angles = self._nc.read('cell_angles').astype(np.float64)
            lengths *= float(self._nc.variables['cell_lengths']
                             .attrs.get('scale_factor', 1.0))
            angles *= float(self._nc.variables['cell_angles']
                            .attrs.get('scale_factor', 1.0))
            if np.abs(lengths).max() > 0:
                self.dimensions = np.concatenate(
                    [lengths, angles], axis=1).astype(np.float32)

    def _load_frames(self, frame_indices) -> np.ndarray:
        frames = self._nc.read(
            'coordinates', records=np.asarray(frame_indices, dtype=np.int64))
        frames = frames.astype(np.float32)
        if self._scale != 1.0:
            frames *= np.float32(self._scale)
        return frames


def open_frame_store(path: str) -> FrameStore:
    """Open a binary trajectory as a lazy frame store.

    The format is chosen by file extension. Lazy stores exist for the
    binary formats where decoding dominates read cost — XTC, TRR, DCD,
    and AMBER NetCDF; text formats (PDB/GRO/XYZ) are always read eagerly
    by :mod:`tfep_tpu_torch.io.traj`.

    Parameters
    ----------
    path : str
        Trajectory file path ending in ``.xtc``, ``.trr``, ``.dcd``,
        ``.nc``, or ``.ncdf``.

    Returns
    -------
    FrameStore
        Lazy coordinate store with eagerly-read ``dimensions`` (unit-cell
        parameters per frame, or None) and ``times`` (ps) attributes.

    Raises
    ------
    ValueError
        If the extension has no lazy reader.
    """
    ext = os.path.splitext(path)[1].lower()
    stores = {'.xtc': XtcFrameStore, '.trr': TrrFrameStore,
              '.dcd': DcdFrameStore, '.nc': NetCDFFrameStore,
              '.ncdf': NetCDFFrameStore}
    if ext not in stores:
        raise ValueError(f'No lazy reader for {ext} files.')
    return stores[ext](path)
