"""Minimal NetCDF-3 (classic / 64-bit-offset) reader for AMBER trajectories.

A copy of ``tfep_tpu/io/netcdf.py`` (numpy only, no JAX).

AMBER's binary trajectory format (``.nc`` / ``.ncdf``) is the "AMBER NetCDF
Trajectory Convention" layered on the NetCDF-3 classic file format: a
self-describing header (dimensions, attributes, variables) followed by
fixed-size and record data sections. The reference reads it through
MDAnalysis (``upstream tfep/io/dataset/traj.py:43-380`` accepts any
MDAnalysis-supported format); this module implements the container natively
so an AMBER user has the full prmtop + .nc pipeline without external
dependencies.

Implements the on-disk format published in the NetCDF classic-format
specification (CDF-1 magic ``CDF\\x01`` with 32-bit offsets and CDF-2 magic
``CDF\\x02`` with 64-bit offsets):

- header: ``magic numrecs dim_list gatt_list var_list``
- each list: 4-byte tag (``NC_DIMENSION``/``NC_ATTRIBUTE``/``NC_VARIABLE``)
  + count + elements; names are length-prefixed bytes padded to 4
- each variable: name, dimension ids, attribute list, external type,
  ``vsize`` (per-record byte size, padded to 4), and a ``begin`` offset
- data: non-record variables at their ``begin``; record variables
  interleaved per record with stride ``recsize`` (sum of their padded
  per-record sizes — unpadded when there is exactly one record variable)

NetCDF-4 (HDF5-based) and CDF-5 files are detected and rejected with a
clear error: AMBER writes classic-format trajectories.

All multi-byte values are big-endian. Type codes: 1 byte, 2 char, 3 short,
4 int, 5 float, 6 double.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ['NetCDFFile', 'NetCDFVariable', 'read_amber_netcdf_header',
           'write_amber_netcdf']

_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C
_ABSENT = 0x00

#: Largest file CDF-1's 32-bit begin offsets can address; past this the
#: writer switches to CDF-2 (64-bit offsets). Module-level so tests can
#: shrink it to exercise the CDF-2 path without writing 2 GiB.
_CDF1_MAX_BYTES = 2**31 - 1

#: external type code -> (numpy dtype (big-endian), size in bytes)
_NC_TYPES = {
    1: (np.dtype('i1'), 1),     # NC_BYTE
    2: (np.dtype('S1'), 1),     # NC_CHAR
    3: (np.dtype('>i2'), 2),    # NC_SHORT
    4: (np.dtype('>i4'), 4),    # NC_INT
    5: (np.dtype('>f4'), 4),    # NC_FLOAT
    6: (np.dtype('>f8'), 8),    # NC_DOUBLE
}


@dataclass
class NetCDFVariable:
    """One variable's metadata from the header."""
    name: str
    dimids: Tuple[int, ...]
    attrs: Dict[str, object]
    nc_type: int
    vsize: int               # per-record bytes, padded (as stored)
    begin: int               # absolute file offset of the data
    shape: Tuple[int, ...]   # resolved dimension lengths (record dim first
                             # reported as the current numrecs)
    is_record: bool

    @property
    def dtype(self) -> np.dtype:
        return _NC_TYPES[self.nc_type][0]


@dataclass
class NetCDFFile:
    """Parsed header of a classic-format NetCDF file."""
    path: str
    version: int                         # 1 (CDF-1) or 2 (CDF-2)
    numrecs: int
    dims: List[Tuple[str, int]] = field(default_factory=list)
    attrs: Dict[str, object] = field(default_factory=dict)
    variables: Dict[str, NetCDFVariable] = field(default_factory=dict)
    recsize: int = 0                     # bytes per record (all record vars)

    # ------------------------------------------------------------------ #
    @classmethod
    def open(cls, path: str) -> 'NetCDFFile':
        with open(path, 'rb') as f:
            try:
                return cls._parse(path, f)
            except ValueError:
                raise                # already carries file context
            except (struct.error, IndexError, KeyError,
                    UnicodeDecodeError) as e:
                # Parse-boundary failures on a malformed file: short reads
                # (struct.error on <4/8 bytes, IndexError on a short
                # magic), corrupt type codes (KeyError in _NC_TYPES),
                # out-of-range dimension ids, or garbage name bytes.
                # Surface them with file context under the same ValueError
                # contract as every other malformed-input path (cf. the
                # DCD reader).
                raise ValueError(
                    f'{path}: truncated or corrupt NetCDF header '
                    f'({type(e).__name__}: {e}).') from e

    @classmethod
    def _parse(cls, path: str, f) -> 'NetCDFFile':
        magic = f.read(4)
        if magic[:3] != b'CDF':
            if magic[:4] == b'\x89HDF':
                raise ValueError(
                    f'{path} is a NetCDF-4/HDF5 file; only classic-format '
                    '(NetCDF-3) AMBER trajectories are supported.')
            raise ValueError(f'{path} is not a NetCDF file '
                             f'(magic {magic!r}).')
        version = magic[3]
        if version not in (1, 2):
            raise ValueError(
                f'{path}: unsupported NetCDF version byte {version} '
                '(CDF-5 is not used by AMBER).')

        nc = cls(path=path, version=version, numrecs=_read_u32(f))

        # Dimension list.
        tag, count = _read_tag(f)
        if tag not in (_NC_DIMENSION, _ABSENT):
            raise ValueError(f'{path}: bad dim_list tag {tag:#x}')
        for _ in range(count):
            name = _read_name(f)
            nc.dims.append((name, _read_u32(f)))

        # Global attributes.
        nc.attrs = _read_att_list(f, path)

        # Variables.
        tag, count = _read_tag(f)
        if tag not in (_NC_VARIABLE, _ABSENT):
            raise ValueError(f'{path}: bad var_list tag {tag:#x}')
        record_vars = []
        for _ in range(count):
            name = _read_name(f)
            ndims = _read_u32(f)
            dimids = tuple(_read_u32(f) for _ in range(ndims))
            attrs = _read_att_list(f, path)
            nc_type = _read_u32(f)
            if nc_type not in _NC_TYPES:
                raise ValueError(
                    f'{path}: variable {name} has unsupported type '
                    f'{nc_type}')
            vsize = _read_u32(f)
            begin = _read_u32(f) if version == 1 else _read_u64(f)

            is_record = bool(dimids) and nc.dims[dimids[0]][1] == 0
            shape = tuple(
                nc.numrecs if (i == 0 and is_record)
                else nc.dims[d][1]
                for i, d in enumerate(dimids))
            var = NetCDFVariable(name=name, dimids=dimids, attrs=attrs,
                                 nc_type=nc_type, vsize=vsize, begin=begin,
                                 shape=shape, is_record=is_record)
            nc.variables[name] = var
            if is_record:
                record_vars.append(var)

        # Record stride: sum of padded per-record sizes, recomputed from
        # the dimensions (the stored vsize saturates at 2^32-1 for large
        # variables). Single record variable -> no padding (spec).
        if len(record_vars) == 1:
            nc.recsize = _record_bytes(record_vars[0], padded=False)
        else:
            nc.recsize = sum(_record_bytes(v, padded=True)
                             for v in record_vars)
        return nc

    # ------------------------------------------------------------------ #
    def read(self, name: str,
             records: Optional[np.ndarray] = None) -> np.ndarray:
        """Read a variable (all of it, or the given record indices).

        Returns a native-endian array shaped like the variable; for a
        record variable with ``records`` given, the leading axis is
        ``len(records)``.
        """
        var = self.variables[name]
        dtype, item = _NC_TYPES[var.nc_type]
        with open(self.path, 'rb') as f:
            if not var.is_record:
                f.seek(var.begin)
                n = int(np.prod(var.shape, dtype=np.int64)) \
                    if var.shape else 1
                data = np.frombuffer(f.read(n * item), dtype=dtype,
                                     count=n)
                return _native(data).reshape(var.shape)

            per_rec_shape = var.shape[1:]
            n_per_rec = int(np.prod(per_rec_shape, dtype=np.int64)) \
                if per_rec_shape else 1
            nbytes = n_per_rec * item
            if records is None:
                records = np.arange(self.numrecs)
            records = np.asarray(records, dtype=np.int64)
            out = np.empty((len(records), n_per_rec), dtype=dtype)
            for i, rec in enumerate(records):
                if not 0 <= rec < self.numrecs:
                    raise IndexError(
                        f'record {rec} out of range '
                        f'(numrecs={self.numrecs})')
                f.seek(var.begin + int(rec) * self.recsize)
                out[i] = np.frombuffer(f.read(nbytes), dtype=dtype,
                                       count=n_per_rec)
        return _native(out).reshape((len(records),) + per_rec_shape)


def _record_bytes(var: NetCDFVariable, padded: bool) -> int:
    item = _NC_TYPES[var.nc_type][1]
    n = int(np.prod(var.shape[1:], dtype=np.int64)) if var.shape[1:] else 1
    nbytes = n * item
    if padded:
        nbytes += -nbytes % 4
    return nbytes


def _native(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == 'S':
        return a
    return a.astype(a.dtype.newbyteorder('='), copy=False)


# -- low-level header primitives ---------------------------------------- #

def _read_u32(f) -> int:
    return struct.unpack('>I', f.read(4))[0]


def _read_u64(f) -> int:
    return struct.unpack('>Q', f.read(8))[0]


def _read_tag(f) -> Tuple[int, int]:
    tag = _read_u32(f)
    count = _read_u32(f)
    return tag, count


def _read_name(f) -> str:
    n = _read_u32(f)
    raw = f.read(n)
    f.read(-n % 4)  # zero padding to 4-byte boundary
    return raw.decode('utf-8')


def _read_att_list(f, path: str) -> Dict[str, object]:
    tag, count = _read_tag(f)
    if tag not in (_NC_ATTRIBUTE, _ABSENT):
        raise ValueError(f'{path}: bad att_list tag {tag:#x}')
    attrs: Dict[str, object] = {}
    for _ in range(count):
        name = _read_name(f)
        nc_type = _read_u32(f)
        nelems = _read_u32(f)
        dtype, item = _NC_TYPES[nc_type]
        raw = f.read(nelems * item)
        f.read(-(nelems * item) % 4)
        if nc_type == 2:  # char array -> string
            attrs[name] = raw.decode('utf-8', errors='replace')
        else:
            values = _native(np.frombuffer(raw, dtype=dtype, count=nelems))
            attrs[name] = values[0] if nelems == 1 else values
    return attrs


# -- writer -------------------------------------------------------------- #

def _name_bytes(name: str) -> bytes:
    raw = name.encode('utf-8')
    return struct.pack('>I', len(raw)) + raw + b'\x00' * (-len(raw) % 4)


def _att_bytes(attrs: Dict[str, object]) -> bytes:
    if not attrs:
        return struct.pack('>II', _ABSENT, 0)
    out = [struct.pack('>II', _NC_ATTRIBUTE, len(attrs))]
    for name, value in attrs.items():
        out.append(_name_bytes(name))
        if isinstance(value, str):
            raw = value.encode('utf-8')
            out.append(struct.pack('>II', 2, len(raw)) + raw
                       + b'\x00' * (-len(raw) % 4))
        else:
            arr = np.atleast_1d(np.asarray(value))
            if arr.dtype.kind == 'f':
                arr = arr.astype('>f8')
                nc_type = 6
            else:
                arr = arr.astype('>i4')
                nc_type = 4
            raw = arr.tobytes()
            out.append(struct.pack('>II', nc_type, len(arr)) + raw
                       + b'\x00' * (-len(raw) % 4))
    return b''.join(out)


def write_amber_netcdf(path: str, positions: np.ndarray,
                       times: Optional[np.ndarray] = None,
                       dimensions: Optional[np.ndarray] = None,
                       title: str = 'written by tfep_tpu') -> None:
    """Write an AMBER NetCDF trajectory (classic CDF-1 format).

    Parameters
    ----------
    positions : ndarray, shape (n_frames, n_atoms, 3)
        Coordinates in angstrom (the AMBER convention unit).
    times : ndarray, shape (n_frames,), optional
        Frame times in ps (default ``0..n_frames-1``).
    dimensions : ndarray, shape (n_frames, 6) or (6,), optional
        Unit-cell ``[lx, ly, lz, alpha, beta, gamma]`` per frame
        (angstrom / degrees); omitted entirely when ``None``.
    title : str, optional
        The trajectory title attribute.
    """
    positions = np.asarray(positions, dtype=np.float32)
    if positions.ndim != 3 or positions.shape[2] != 3:
        raise ValueError('positions must have shape (n_frames, n_atoms, 3)')
    n_frames, n_atoms, _ = positions.shape
    if times is None:
        times = np.arange(n_frames, dtype=np.float32)
    times = np.asarray(times, dtype=np.float32)
    if dimensions is not None:
        dimensions = np.asarray(dimensions, dtype=np.float64)
        if dimensions.ndim == 1:
            dimensions = np.tile(dimensions, (n_frames, 1))

    # Dimensions (frame must be the record dimension).
    dims = [('frame', 0), ('spatial', 3), ('atom', n_atoms)]
    if dimensions is not None:
        dims += [('cell_spatial', 3), ('cell_angular', 3)]
    dim_id = {name: i for i, (name, _) in enumerate(dims)}

    gattrs = {
        'Conventions': 'AMBER',
        'ConventionVersion': '1.0',
        'program': 'tfep_tpu',
        'programVersion': '1.0',
        'title': title,
    }

    # (name, dimids, attrs, nc_type, per-record element count, data)
    variables = [
        ('spatial', (dim_id['spatial'],), {}, 2, 3,
         np.frombuffer(b'xyz', dtype='S1')),
        ('time', (dim_id['frame'],), {'units': 'picosecond'}, 5, 1, times),
        ('coordinates',
         (dim_id['frame'], dim_id['atom'], dim_id['spatial']),
         {'units': 'angstrom'}, 5, n_atoms * 3, positions),
    ]
    if dimensions is not None:
        variables += [
            ('cell_lengths', (dim_id['frame'], dim_id['cell_spatial']),
             {'units': 'angstrom'}, 6, 3,
             dimensions[:, :3].astype('>f8')),
            ('cell_angles', (dim_id['frame'], dim_id['cell_angular']),
             {'units': 'degree'}, 6, 3,
             dimensions[:, 3:].astype('>f8')),
        ]

    record_vars = [v for v in variables if v[1] and v[1][0] == dim_id['frame']]
    fixed_vars = [v for v in variables if v not in record_vars]

    def var_vsize(v):
        _, _, _, nc_type, count, _ = v
        nbytes = count * _NC_TYPES[nc_type][1]
        return nbytes + (-nbytes % 4)

    # Serialize the header once with zero begins to learn its length.
    def header_bytes(begins, version):
        begin_fmt = '>I' if version == 1 else '>Q'
        out = [b'CDF' + bytes([version]), struct.pack('>I', n_frames)]
        out.append(struct.pack('>II', _NC_DIMENSION, len(dims)))
        for name, length in dims:
            out.append(_name_bytes(name) + struct.pack('>I', length))
        out.append(_att_bytes(gattrs))
        out.append(struct.pack('>II', _NC_VARIABLE, len(variables)))
        for v in variables:
            name, dimids, attrs, nc_type, _, _ = v
            out.append(_name_bytes(name))
            out.append(struct.pack('>I', len(dimids)))
            out.append(struct.pack(f'>{len(dimids)}I', *dimids)
                       if dimids else b'')
            out.append(_att_bytes(attrs))
            out.append(struct.pack('>II', nc_type, var_vsize(v)))
            out.append(struct.pack(begin_fmt, begins[name]))
        return b''.join(out)

    def layout(version):
        header_len = len(header_bytes({v[0]: 0 for v in variables},
                                      version))
        begins: Dict[str, int] = {}
        offset = header_len
        for v in fixed_vars:
            begins[v[0]] = offset
            offset += var_vsize(v)
        for v in record_vars:
            begins[v[0]] = offset
            offset += var_vsize(v)
        return begins, offset

    # CDF-1 stores 32-bit offsets; fall back to CDF-2 (64-bit) when any
    # variable would begin past 2 GiB.
    version = 1
    begins, data_start = layout(version)
    total = data_start + (n_frames - 1) * max(
        sum(var_vsize(v) for v in record_vars), 1)
    if total > _CDF1_MAX_BYTES:
        version = 2
        begins, _ = layout(version)

    with open(path, 'wb') as f:
        f.write(header_bytes(begins, version))
        for name, _, _, nc_type, count, data in fixed_vars:
            dtype = _NC_TYPES[nc_type][0]
            raw = np.asarray(data).astype(dtype).tobytes()
            f.write(raw + b'\x00' * (-len(raw) % 4))
        # Records: each record holds every record variable's slab, padded
        # to 4 bytes (no padding when there is exactly one record var).
        for rec in range(n_frames):
            for v in record_vars:
                name, _, _, nc_type, count, data = v
                dtype = _NC_TYPES[nc_type][0]
                raw = np.asarray(data[rec]).astype(dtype).tobytes()
                pad = (-len(raw) % 4) if len(record_vars) > 1 else 0
                f.write(raw + b'\x00' * pad)


# -- AMBER convention helpers ------------------------------------------- #

def read_amber_netcdf_header(path: str) -> NetCDFFile:
    """Open an AMBER NetCDF trajectory and validate the convention.

    The AMBER convention requires ``Conventions`` to include ``AMBER``,
    a record dimension ``frame``, fixed dimensions ``atom`` and
    ``spatial`` (= 3), and a float ``coordinates(frame, atom, spatial)``
    variable in angstrom. ``cell_lengths``/``cell_angles`` and ``time``
    are optional.
    """
    nc = NetCDFFile.open(path)
    conventions = str(nc.attrs.get('Conventions', ''))
    if 'AMBER' not in conventions:
        raise ValueError(
            f'{path}: Conventions={conventions!r} is not an AMBER '
            'trajectory.')
    if 'coordinates' not in nc.variables:
        raise ValueError(f'{path}: no coordinates variable.')
    coords = nc.variables['coordinates']
    if len(coords.shape) != 3 or coords.shape[2] != 3:
        raise ValueError(
            f'{path}: coordinates has shape {coords.shape}, expected '
            '(frame, atom, 3).')
    if not coords.is_record:
        raise ValueError(f'{path}: coordinates is not a record variable.')
    units = str(coords.attrs.get('units', 'angstrom')).lower()
    if units not in ('angstrom', 'angstroms'):
        raise ValueError(
            f'{path}: coordinates units {units!r} not supported '
            '(the AMBER convention mandates angstrom).')
    return nc
