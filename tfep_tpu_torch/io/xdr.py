"""GROMACS XDR trajectory formats: XTC (compressed) and TRR.

A copy of ``tfep_tpu/io/xdr.py`` (numpy only, no JAX).

Pure-Python reference codec for both formats — reader *and* writer, so the
intricate XTC integer compression is round-trip tested without external MD
libraries. The native C++ decoder (tfep_tpu_torch/native/trajio.cpp) is the fast
path for production reads; this module is the correctness oracle and the
fallback when no compiler is available.

The XTC coordinate compression ("3dfcoord") is implemented from the format
specification: coordinates are quantized to ints by ``precision``, the
frame's bounding box gives per-axis bit widths, and runs of atoms whose
successive deltas are small are stored as delta-encoded triples using a
geometric table of integer ranges (``MAGICINTS``) with adaptive range
switching. All values are big-endian; bits are packed MSB-first.

Reference capability: the reference reads XTC/TRR through MDAnalysis
(upstream tfep/io/dataset/traj.py:43); this is a from-scratch
replacement, not a port.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np

__all__ = ['read_xtc', 'write_xtc', 'read_trr', 'write_trr',
           'iter_trr_frames', 'scan_xtc_offsets', 'scan_trr_offsets',
           'XTC_MAGIC', 'TRR_MAGIC']

XTC_MAGIC = 1995
TRR_MAGIC = 1993

# Geometric ladder of integer ranges (ratio 2^(1/4)) used by the XTC
# compressor to pick how many bits a small delta needs. Indices below
# FIRSTIDX are unused.
MAGICINTS = [
    0, 0, 0, 0, 0, 0, 0, 0, 0,
    8, 10, 12, 16, 20, 25, 32, 40, 50, 64,
    80, 101, 128, 161, 203, 256, 322, 406, 512,
    645, 812, 1024, 1290, 1625, 2048, 2580, 3250, 4096,
    5060, 6501, 8192, 10321, 13003, 16384, 20642, 26007, 32768,
    41285, 52015, 65536, 82570, 104031, 131072, 165140, 208063, 262144,
    330280, 416127, 524287, 660561, 832255, 1048576, 1321122, 1664510,
    2097152, 2642245, 3329021, 4194304, 5284491, 6658042, 8388607,
    10568983, 13316085, 16777216,
]
FIRSTIDX = 9
LASTIDX = len(MAGICINTS) - 1


# =============================================================================
# Bit-stream primitives (MSB-first within the byte stream)
# =============================================================================

class _BitWriter:
    """Append values MSB-first to a growing byte buffer."""

    def __init__(self):
        self.bytes = bytearray()
        self.partial = 0      # bits not yet flushed to a full byte
        self.n_partial = 0

    def put(self, n_bits: int, value: int):
        value &= (1 << n_bits) - 1 if n_bits < 64 else ~0
        self.partial = (self.partial << n_bits) | value
        self.n_partial += n_bits
        while self.n_partial >= 8:
            self.n_partial -= 8
            self.bytes.append((self.partial >> self.n_partial) & 0xFF)
        self.partial &= (1 << self.n_partial) - 1

    def put_mixed(self, n_bits: int, radices, digits):
        """Encode mixed-radix digits as one n_bits-wide integer.

        The combined value is emitted least-significant byte first, then
        any remaining high bits — matching the XTC byte layout.
        """
        combined = int(digits[0])
        for radix, digit in zip(radices[1:], digits[1:]):
            combined = combined * int(radix) + int(digit)
        n_bytes = max(1, (combined.bit_length() + 7) // 8)
        if n_bits >= n_bytes * 8:
            for i in range(n_bytes):
                self.put(8, (combined >> (8 * i)) & 0xFF)
            self.put(n_bits - n_bytes * 8, 0)
        else:
            for i in range(n_bytes - 1):
                self.put(8, (combined >> (8 * i)) & 0xFF)
            self.put(n_bits - (n_bytes - 1) * 8,
                     combined >> (8 * (n_bytes - 1)))

    def getvalue(self) -> bytes:
        out = bytearray(self.bytes)
        if self.n_partial:
            out.append((self.partial << (8 - self.n_partial)) & 0xFF)
        return bytes(out)


class _BitReader:
    """Read values MSB-first from a byte buffer."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0          # next byte index
        self.partial = 0
        self.n_partial = 0

    def get(self, n_bits: int) -> int:
        while self.n_partial < n_bits:
            self.partial = (self.partial << 8) | self.data[self.pos]
            self.pos += 1
            self.n_partial += 8
        self.n_partial -= n_bits
        value = self.partial >> self.n_partial
        self.partial &= (1 << self.n_partial) - 1
        return value

    def get_mixed(self, n_bits: int, radices) -> List[int]:
        """Decode one n_bits integer back into mixed-radix digits."""
        combined = 0
        shift = 0
        while n_bits > 8:
            combined |= self.get(8) << shift
            shift += 8
            n_bits -= 8
        if n_bits > 0:
            combined |= self.get(n_bits) << shift
        digits = [0] * len(radices)
        for i in range(len(radices) - 1, 0, -1):
            combined, digits[i] = divmod(combined, int(radices[i]))
        digits[0] = combined
        return digits


def _bits_for(max_value: int) -> int:
    """Bits needed so every value in [0, max_value] fits."""
    return int(max_value).bit_length()


def _bits_for_triple(sizes) -> int:
    """Bits needed for a mixed-radix triple with the given ranges."""
    product = int(sizes[0]) * int(sizes[1]) * int(sizes[2])
    return product.bit_length()


# =============================================================================
# XTC coordinate compression
# =============================================================================

def _compress_coords(coords: np.ndarray, precision: float) -> bytes:
    """Compress (n_atoms, 3) nm coordinates; returns the xdr3dfcoord body
    (everything after the repeated atom count)."""
    n_atoms = coords.shape[0]
    out = bytearray()
    if n_atoms <= 9:
        out += struct.pack('>%df' % (n_atoms * 3),
                           *coords.reshape(-1).astype(np.float32))
        return bytes(out)

    out += struct.pack('>f', precision)
    # Quantize (round half away from zero, like the format's reference
    # implementation truncates after +/-0.5).
    scaled = coords.astype(np.float64) * precision
    ints = np.where(scaled >= 0, np.floor(scaled + 0.5),
                    np.ceil(scaled - 0.5)).astype(np.int64)
    if np.abs(ints).max() > 2 ** 31 - 2:
        raise ValueError('Coordinates too large for XTC precision.')

    minint = ints.min(axis=0)
    maxint = ints.max(axis=0)
    out += struct.pack('>3i', *minint)
    out += struct.pack('>3i', *maxint)

    sizeint = (maxint - minint + 1).astype(np.int64)
    if (sizeint > 0xFFFFFF).any():
        bitsizeint = [_bits_for(s - 1 + 1) for s in sizeint]
        bitsize = 0
    else:
        bitsizeint = [0, 0, 0]
        bitsize = _bits_for_triple(sizeint)

    # Typical nearest-neighbour delta sets the starting small range.
    diffs = np.abs(np.diff(ints, axis=0)).sum(axis=1)
    mindiff = int(diffs.min()) if len(diffs) else 0
    smallidx = FIRSTIDX
    while smallidx < LASTIDX and MAGICINTS[smallidx] < mindiff:
        smallidx += 1
    out += struct.pack('>i', smallidx)

    maxidx = min(LASTIDX, smallidx + 8)
    minidx = maxidx - 8
    smaller = MAGICINTS[max(FIRSTIDX, smallidx - 1)] // 2
    smallnum = MAGICINTS[smallidx] // 2
    sizesmall = [MAGICINTS[smallidx]] * 3
    larger = MAGICINTS[maxidx] // 2

    writer = _BitWriter()
    work = ints.copy()
    prev = np.zeros(3, dtype=np.int64)
    prevrun = -1
    i = 0
    while i < n_atoms:
        # Decide whether to drift the small range up/down after this atom.
        if (smallidx < maxidx and i >= 1
                and (np.abs(work[i] - prev) < larger).all()):
            is_smaller = 1
        elif smallidx > minidx:
            is_smaller = -1
        else:
            is_smaller = 0

        # If the next atom is within the small range, swap it in front so
        # the run can start immediately (water-molecule heuristic).
        is_small = False
        if i + 1 < n_atoms and \
                (np.abs(work[i] - work[i + 1]) < smallnum).all():
            work[[i, i + 1]] = work[[i + 1, i]]
            is_small = True

        anchor = work[i] - minint
        if bitsize == 0:
            for k in range(3):
                writer.put(bitsizeint[k], int(anchor[k]))
        else:
            writer.put_mixed(bitsize, sizeint, anchor)
        prev = work[i].copy()
        i += 1

        run_deltas = []
        if not is_small and is_smaller == -1:
            is_smaller = 0
        while is_small and len(run_deltas) < 8:
            if is_smaller == -1 and \
                    int(((work[i] - prev) ** 2).sum()) >= smaller * smaller:
                is_smaller = 0
            run_deltas.append(work[i] - prev + smallnum)
            prev = work[i].copy()
            i += 1
            is_small = (i < n_atoms
                        and (np.abs(work[i] - prev) < smallnum).all())

        run = len(run_deltas) * 3
        if run != prevrun or is_smaller != 0:
            prevrun = run
            writer.put(1, 1)
            writer.put(5, run + is_smaller + 1)
        else:
            writer.put(1, 0)
        for delta in run_deltas:
            writer.put_mixed(smallidx, sizesmall, delta)

        if is_smaller != 0:
            smallidx += is_smaller
            if is_smaller < 0:
                smallnum = smaller
                smaller = (MAGICINTS[smallidx - 1] // 2
                           if smallidx > FIRSTIDX else 0)
            else:
                smaller = smallnum
                smallnum = MAGICINTS[smallidx] // 2
            sizesmall = [MAGICINTS[smallidx]] * 3

    payload = writer.getvalue()
    out += struct.pack('>i', len(payload))
    out += payload
    out += b'\x00' * (-len(payload) % 4)
    return bytes(out)


def _decompress_coords(data: bytes, offset: int, n_atoms: int
                       ) -> Tuple[np.ndarray, int]:
    """Inverse of :func:`_compress_coords`; returns (coords_nm, new_offset)."""
    if n_atoms <= 9:
        coords = np.frombuffer(data, '>f4', n_atoms * 3, offset)
        return coords.reshape(n_atoms, 3).astype(np.float64), \
            offset + 4 * n_atoms * 3

    precision, = struct.unpack_from('>f', data, offset)
    minint = np.asarray(struct.unpack_from('>3i', data, offset + 4),
                        dtype=np.int64)
    maxint = np.asarray(struct.unpack_from('>3i', data, offset + 16),
                        dtype=np.int64)
    smallidx, n_bytes = struct.unpack_from('>ii', data, offset + 28)
    offset += 36
    payload = data[offset:offset + n_bytes]
    offset += n_bytes + (-n_bytes % 4)

    sizeint = maxint - minint + 1
    if (sizeint > 0xFFFFFF).any():
        bitsizeint = [_bits_for(int(s)) for s in sizeint]
        bitsize = 0
    else:
        bitsizeint = [0, 0, 0]
        bitsize = _bits_for_triple(sizeint)

    smaller = MAGICINTS[max(FIRSTIDX, smallidx - 1)] // 2
    smallnum = MAGICINTS[smallidx] // 2
    sizesmall = [MAGICINTS[smallidx]] * 3

    reader = _BitReader(payload)
    coords = np.empty((n_atoms, 3), dtype=np.int64)
    run = 0
    i = 0
    while i < n_atoms:
        if bitsize == 0:
            anchor = [reader.get(b) for b in bitsizeint]
        else:
            anchor = reader.get_mixed(bitsize, sizeint)
        this = np.asarray(anchor, dtype=np.int64) + minint
        prev = this.copy()
        seed_row = i
        coords[i] = this
        i += 1

        is_smaller = 0
        if reader.get(1):
            value = reader.get(5)
            is_smaller = value % 3 - 1
            run = value - (is_smaller + 1)
        for k in range(0, run, 3):
            delta = np.asarray(reader.get_mixed(smallidx, sizesmall),
                               dtype=np.int64)
            this = delta + prev - smallnum
            if k == 0:
                # The run's first atom was swapped in front of its seed.
                coords[seed_row] = this
                coords[i] = prev
                prev = this
            else:
                coords[i] = this
                prev = this
            i += 1

        if is_smaller < 0:
            smallidx -= 1
            smallnum = smaller
            smaller = (MAGICINTS[smallidx - 1] // 2
                       if smallidx > FIRSTIDX else 0)
        elif is_smaller > 0:
            smallidx += 1
            smaller = smallnum
            smallnum = MAGICINTS[smallidx] // 2
        if is_smaller != 0:
            sizesmall = [MAGICINTS[smallidx]] * 3

    return coords.astype(np.float64) / precision, offset


# =============================================================================
# XTC frames
# =============================================================================

def write_xtc(path: str, positions_nm: np.ndarray,
              boxes_nm: Optional[np.ndarray] = None,
              times_ps: Optional[np.ndarray] = None,
              precision: float = 1000.0):
    """Write an XTC trajectory.

    Parameters
    ----------
    path : str
        Output file path.
    positions_nm : numpy.ndarray
        Coordinates in nm, shape ``(n_frames, n_atoms, 3)``.
    boxes_nm : numpy.ndarray, optional
        Triclinic box vectors in nm, shape ``(n_frames, 3, 3)``; zero
        matrices are written when omitted (GROMACS convention for "no
        box").
    times_ps : numpy.ndarray, optional
        Frame times in ps; defaults to the frame index.
    precision : float, optional
        Quantization factor: coordinates are stored as
        ``round(x * precision)`` integers, so the default 1000 keeps
        0.001 nm resolution — the GROMACS default.
    """
    positions_nm = np.asarray(positions_nm, dtype=np.float64)
    n_frames, n_atoms = positions_nm.shape[:2]
    with open(path, 'wb') as f:
        for frame in range(n_frames):
            time = float(times_ps[frame]) if times_ps is not None else \
                float(frame)
            box = (np.zeros((3, 3)) if boxes_nm is None
                   else np.asarray(boxes_nm[frame]).reshape(3, 3))
            f.write(struct.pack('>iiif', XTC_MAGIC, n_atoms, frame, time))
            f.write(struct.pack('>9f', *box.reshape(-1)))
            f.write(struct.pack('>i', n_atoms))
            f.write(_compress_coords(positions_nm[frame], precision))


def _read_xtc_frame(data: bytes, offset: int):
    magic, n_atoms, step, time = struct.unpack_from('>iiif', data, offset)
    if magic != XTC_MAGIC:
        raise ValueError(f'Bad XTC magic {magic} at offset {offset}.')
    box = np.asarray(struct.unpack_from('>9f', data, offset + 16)
                     ).reshape(3, 3)
    n_atoms2, = struct.unpack_from('>i', data, offset + 52)
    if n_atoms2 != n_atoms:
        raise ValueError('Inconsistent XTC atom counts.')
    coords, offset = _decompress_coords(data, offset + 56, n_atoms)
    return coords, box, float(time), step, offset


def read_xtc(path: str):
    """Read an XTC trajectory into memory.

    For lazy per-frame access to large files use
    :class:`tfep_tpu_torch.io.frames.XtcFrameStore` instead.

    Parameters
    ----------
    path : str
        XTC file path.

    Returns
    -------
    positions_nm : numpy.ndarray
        ``(n_frames, n_atoms, 3)`` coordinates in nm (lossy at the file's
        stored precision).
    boxes_nm : numpy.ndarray
        ``(n_frames, 3, 3)`` box vectors in nm.
    times_ps : numpy.ndarray
        ``(n_frames,)`` frame times in ps.
    """
    with open(path, 'rb') as f:
        data = f.read()
    frames, boxes, times = [], [], []
    offset = 0
    while offset < len(data):
        coords, box, time, _, offset = _read_xtc_frame(data, offset)
        frames.append(coords)
        boxes.append(box)
        times.append(time)
    return (np.asarray(frames), np.asarray(boxes),
            np.asarray(times, dtype=np.float64))


def scan_xtc_offsets(path: str) -> Tuple[np.ndarray, int]:
    """Byte offset of every frame (for lazy access). Returns (offsets, n_atoms).

    Scans headers only — frame payloads are skipped by their byte counts,
    so indexing a multi-gigabyte file touches a few bytes per frame.
    """
    offsets = []
    n_atoms_first = None
    with open(path, 'rb') as f:
        file_size = os.fstat(f.fileno()).st_size
        offset = 0
        while offset < file_size:
            offsets.append(offset)
            header = f.read(16)
            magic, n_atoms, _, _ = struct.unpack('>iiif', header)
            if magic != XTC_MAGIC:
                raise ValueError(f'Bad XTC magic {magic} at {offset}.')
            if n_atoms_first is None:
                n_atoms_first = n_atoms
            if n_atoms <= 9:
                offset += 56 + 12 * n_atoms
            else:
                f.seek(offset + 88)  # header + box + natoms + prec + bounds
                n_bytes, = struct.unpack('>i', f.read(4))
                offset += 92 + n_bytes + (-n_bytes % 4)
            f.seek(offset)
    return np.asarray(offsets, dtype=np.int64), int(n_atoms_first or 0)


# =============================================================================
# TRR
# =============================================================================

_TRR_TITLE = b'GMX_trn_file'


def write_trr(path: str, positions_nm: np.ndarray,
              boxes_nm: Optional[np.ndarray] = None,
              times_ps: Optional[np.ndarray] = None,
              velocities_nm_ps: Optional[np.ndarray] = None,
              forces: Optional[np.ndarray] = None,
              double: bool = False):
    """Write a TRR trajectory.

    Parameters
    ----------
    path : str
        Output file path.
    positions_nm : numpy.ndarray
        Coordinates in nm, shape ``(n_frames, n_atoms, 3)``.
    boxes_nm, times_ps, velocities_nm_ps, forces : numpy.ndarray, optional
        Per-frame box vectors ``(n_frames, 3, 3)``, times (ps),
        velocities (nm/ps), and forces; blocks are omitted from the file
        when None (TRR encodes presence via per-block byte sizes).
    double : bool, optional
        Store values as float64 instead of float32.
    """
    positions_nm = np.asarray(positions_nm, dtype=np.float64)
    n_frames, n_atoms = positions_nm.shape[:2]
    real, real_size = ('>d', 8) if double else ('>f', 4)

    def vec_block(array):
        return struct.pack(real.replace('>', '>%d' % array.size),
                           *array.reshape(-1))

    with open(path, 'wb') as f:
        for frame in range(n_frames):
            box_size = 9 * real_size if boxes_nm is not None else 0
            x_size = n_atoms * 3 * real_size
            v_size = (n_atoms * 3 * real_size
                      if velocities_nm_ps is not None else 0)
            f_size = n_atoms * 3 * real_size if forces is not None else 0
            time = float(times_ps[frame]) if times_ps is not None else \
                float(frame)
            # Header magic, C-string length (incl. NUL), then the title as
            # an XDR string (its own length + bytes padded to 4).
            f.write(struct.pack('>ii', TRR_MAGIC, len(_TRR_TITLE) + 1))
            f.write(struct.pack('>i', len(_TRR_TITLE)))
            f.write(_TRR_TITLE + b'\x00' * (-len(_TRR_TITLE) % 4))
            f.write(struct.pack('>13i',
                                0, 0, box_size, 0, 0, 0, 0,
                                x_size, v_size, f_size, n_atoms, frame, 0))
            f.write(struct.pack(real, time))
            f.write(struct.pack(real, 0.0))  # lambda
            if boxes_nm is not None:
                f.write(vec_block(np.asarray(boxes_nm[frame]).reshape(3, 3)))
            f.write(vec_block(positions_nm[frame]))
            if velocities_nm_ps is not None:
                f.write(vec_block(np.asarray(velocities_nm_ps[frame])))
            if forces is not None:
                f.write(vec_block(np.asarray(forces[frame])))


def _read_trr_frame(data: bytes, offset: int):
    magic, _c_len = struct.unpack_from('>ii', data, offset)
    if magic != TRR_MAGIC:
        raise ValueError(f'Bad TRR magic {magic} at offset {offset}.')
    offset += 8
    title_len, = struct.unpack_from('>i', data, offset)
    offset += 4 + title_len + (-title_len % 4)
    (ir_size, e_size, box_size, vir_size, pres_size, top_size, sym_size,
     x_size, v_size, f_size, n_atoms, step, nre) = struct.unpack_from(
        '>13i', data, offset)
    offset += 52

    # Float vs double detected from the per-block byte sizes. Any vector
    # block works; force-only frames (mdrun -rerun with no box) must fall
    # through to v/f before the f4 default.
    if box_size:
        real_size = box_size // 9
    elif x_size:
        real_size = x_size // (3 * n_atoms)
    elif v_size:
        real_size = v_size // (3 * n_atoms)
    elif f_size:
        real_size = f_size // (3 * n_atoms)
    else:
        real_size = 4
    real = '>f8' if real_size == 8 else '>f4'

    time, lam = np.frombuffer(data, real, 2, offset)
    offset += 2 * real_size
    offset += ir_size + e_size  # unused legacy blocks

    def vec_block(n_bytes, shape):
        nonlocal offset
        if n_bytes == 0:
            return None
        values = np.frombuffer(data, real, n_bytes // real_size, offset)
        offset += n_bytes
        return values.astype(np.float64).reshape(shape)

    box = vec_block(box_size, (3, 3))
    offset += vir_size + pres_size + top_size + sym_size
    x = vec_block(x_size, (n_atoms, 3))
    v = vec_block(v_size, (n_atoms, 3))
    forces = vec_block(f_size, (n_atoms, 3))
    return x, v, forces, box, float(time), step, offset


def read_trr(path: str):
    """Read a TRR trajectory into memory.

    Frames without coordinates (e.g. force-only frames from
    ``mdrun -rerun``) are skipped. Float32 and float64 files are both
    supported; the width is detected per frame from the block byte sizes.

    Parameters
    ----------
    path : str
        TRR file path.

    Returns
    -------
    positions_nm : numpy.ndarray
        ``(n_frames, n_atoms, 3)`` coordinates in nm.
    boxes_nm : numpy.ndarray or None
        ``(n_frames, 3, 3)`` box vectors, or None if any frame lacks one.
    times_ps : numpy.ndarray
        ``(n_frames,)`` frame times in ps.
    """
    with open(path, 'rb') as f:
        data = f.read()
    frames, boxes, times = [], [], []
    offset = 0
    while offset < len(data):
        x, _, _, box, time, _, offset = _read_trr_frame(data, offset)
        if x is None:
            continue
        frames.append(x)
        boxes.append(box)
        times.append(time)
    has_box = all(b is not None for b in boxes) and len(boxes) > 0
    return (np.asarray(frames),
            np.asarray(boxes) if has_box else None,
            np.asarray(times, dtype=np.float64))


def iter_trr_frames(path: str):
    """Yield every TRR frame as a dict, including coordinate-less ones.

    ``read_trr`` returns only frames carrying coordinates; this generator
    exposes the full record — notably force-only frames, which is what
    ``gmx mdrun -rerun`` writes when asked for forces alone (the form the
    reference's MiMiC test data ships in).

    Yields
    ------
    frame : dict
        Keys ``positions``, ``velocities``, ``forces`` (each an
        ``(n_atoms, 3)`` float64 array in GROMACS units, or None when the
        block is absent), ``box`` (``(3, 3)`` nm or None), ``time`` (ps)
        and ``step``.
    """
    with open(path, 'rb') as f:
        data = f.read()
    offset = 0
    while offset < len(data):
        x, v, forces, box, time, step, offset = _read_trr_frame(data, offset)
        yield {'positions': x, 'velocities': v, 'forces': forces,
               'box': box, 'time': time, 'step': step}


def scan_trr_offsets(path: str) -> Tuple[np.ndarray, int]:
    """Byte offset of every TRR frame holding coordinates."""
    with open(path, 'rb') as f:
        data = f.read()
    offsets = []
    n_atoms_first = 0
    offset = 0
    while offset < len(data):
        start = offset
        x, _, _, _, _, _, offset = _read_trr_frame(data, offset)
        if x is not None:
            offsets.append(start)
            n_atoms_first = n_atoms_first or x.shape[0]
    return np.asarray(offsets, dtype=np.int64), n_atoms_first
