"""The port's trajectory and topology files against the JAX package's.

``tfep_tpu_torch/io/{native,xdr,dcd,netcdf,frames,restart,topfiles,writers}``
and the file branch of ``io/traj.py`` are copies of numpy-only modules of
the JAX package, and ``tfep_tpu_torch/native/trajio.cpp`` is a copy of its
C++ decoder. Each case below runs once with the names of one package and
once with those of the other, each in a directory of its own holding the
same inputs, and the two results must be identical bit for bit: arrays,
topologies, the bytes of every file a writer wrote, and the type and
message of every error. The cases follow ``tests/io/test_formats.py``,
``test_dcd.py``, ``test_netcdf.py``, ``test_psf_restart.py`` and
``test_xtc_gold.py``, whose input helpers and texts they load. Then the
files one package wrote are read by the other, the golden files of
``tests/data`` are read by both, the native decoder is held against the
pure-Python one, and the port's loader is shown to build its own copy of
the source into ``build/native/``.
"""

import functools
import importlib.util
import os
import struct
import subprocess
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import tfep_tpu.io.dcd as jax_dcd
import tfep_tpu.io.frames as jax_frames
import tfep_tpu.io.native as jax_native
import tfep_tpu.io.netcdf as jax_netcdf
import tfep_tpu.io.restart as jax_restart
import tfep_tpu.io.topfiles as jax_topfiles
import tfep_tpu.io.topology as jax_topology
import tfep_tpu.io.traj as jax_traj
import tfep_tpu.io.writers as jax_writers
import tfep_tpu.io.xdr as jax_xdr
import tfep_tpu_torch.io.dcd as port_dcd
import tfep_tpu_torch.io.frames as port_frames
import tfep_tpu_torch.io.native as port_native
import tfep_tpu_torch.io.netcdf as port_netcdf
import tfep_tpu_torch.io.restart as port_restart
import tfep_tpu_torch.io.topfiles as port_topfiles
import tfep_tpu_torch.io.topology as port_topology
import tfep_tpu_torch.io.traj as port_traj
import tfep_tpu_torch.io.writers as port_writers
import tfep_tpu_torch.io.xdr as port_xdr

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / 'tests' / 'data'


def _names(dcd, frames, native, netcdf, restart, topfiles, topology, traj,
           writers, xdr):
    return SimpleNamespace(dcd=dcd, frames=frames, native=native,
                           netcdf=netcdf, restart=restart, topfiles=topfiles,
                           topology=topology, traj=traj, writers=writers,
                           xdr=xdr, System=traj.System,
                           Topology=topology.Topology)


JAX = _names(jax_dcd, jax_frames, jax_native, jax_netcdf, jax_restart,
             jax_topfiles, jax_topology, jax_traj, jax_writers, jax_xdr)
PORT = _names(port_dcd, port_frames, port_native, port_netcdf, port_restart,
              port_topfiles, port_topology, port_traj, port_writers,
              port_xdr)


def _load(name):
    """A module of ``tests/io`` for its input helpers and texts."""
    spec = importlib.util.spec_from_file_location(
        f'_torch_io_files_{name}', ROOT / 'tests' / 'io' / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


FORMATS = _load('test_formats')
DCD = _load('test_dcd')
RESTART = _load('test_psf_restart')
XTC_GOLD = _load('test_xtc_gold')


# --------------------------------------------------------------------------
# Comparison
# --------------------------------------------------------------------------

def _top(topology):
    return dict(names=topology.names, elements=topology.elements,
                resnames=topology.resnames, resids=topology.resids,
                masses=topology.masses, bonds=topology.bonds)


def _sys(system):
    return dict(positions=np.asarray(system.positions),
                dimensions=system.dimensions, times=system.times,
                topology=_top(system.topology))


def _error(fn, d):
    """The type and message of what ``fn()`` raises, with the case's
    directory and the package's name taken out."""
    try:
        fn()
    except Exception as error:  # noqa: BLE001 (compared across packages)
        message = str(error).replace(str(d), '<dir>')
        return type(error).__name__, message.replace('tfep_tpu_torch',
                                                     'tfep_tpu')
    raise AssertionError('no error raised')


def assert_same(port, ref, where='result'):
    """Equal structure, and equal values bit for bit (NaNs in the same
    places)."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and list(port) == list(ref), where
        for key in ref:
            assert_same(port[key], ref[key], f'{where}[{key!r}]')
    elif isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref), \
            where
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_same(a, b, f'{where}[{i}]')
    elif ref is None or isinstance(ref, (str, bool, bytes)):
        assert port == ref, where
    else:
        port, ref = np.asarray(port), np.asarray(ref)
        assert port.shape == ref.shape, where
        assert port.dtype == ref.dtype, where
        np.testing.assert_array_equal(port, ref, err_msg=where)


def _clustered(seed, n_frames=4, n_mol=20, atoms_per_mol=3):
    """Clustered coordinates (nm, like waters) for the XTC run-length
    path, as ``tests/io/test_formats.py`` builds them."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 4.0, (n_frames, n_mol, 1, 3))
    local = rng.normal(0, 0.05, (n_frames, n_mol, atoms_per_mol, 3))
    return (centers + local).reshape(n_frames, n_mol * atoms_per_mol, 3)


def _writer_system(m, n_frames=3, n_atoms=5, seed=7, triclinic=False):
    rng = np.random.default_rng(seed)
    topology = m.Topology(
        names=['C1', 'O1', 'H1', 'H2', 'N1'][:n_atoms],
        elements=['C', 'O', 'H', 'H', 'N'][:n_atoms],
        resnames=['MOL'] * n_atoms, resids=[1] * n_atoms,
        bonds=[(0, 1), (0, 2), (1, 3)])
    positions = rng.uniform(0.0, 9.0, size=(n_frames, n_atoms, 3))
    angles = [80.0, 95.0, 100.0] if triclinic else [90.0, 90.0, 90.0]
    dims = np.tile([20.0, 22.0, 25.0] + angles, (n_frames, 1))
    return m.System(topology, positions, dims)


# --------------------------------------------------------------------------
# XTC / TRR codecs (tests/io/test_formats.py, test_xtc_gold.py)
# --------------------------------------------------------------------------

def xtc_roundtrip(m, d, n_mol):
    pos = _clustered(1, n_mol=n_mol)
    boxes = np.tile(np.diag([4.0, 4.0, 4.0]), (4, 1, 1))
    path = str(d / 't.xtc')
    m.xdr.write_xtc(path, pos, boxes, np.arange(4) * 0.002,
                    precision=1000.0)
    return [m.xdr.read_xtc(path), Path(path).read_bytes()]


def xtc_wide_coordinate_range(m, d):
    pos = np.random.default_rng(2).uniform(-9000, 9000, (2, 20, 3))
    path = str(d / 't.xtc')
    m.xdr.write_xtc(path, pos, precision=1000.0)
    return [m.xdr.read_xtc(path), Path(path).read_bytes()]


def xtc_too_large_raises(m, d):
    return _error(lambda: m.xdr.write_xtc(
        str(d / 't.xtc'), np.full((1, 12, 3), 3e6)), d)


def trr_roundtrip(m, d, double):
    pos = _clustered(3, n_mol=4)
    boxes = np.tile(np.diag([4.0, 4.0, 4.0]), (4, 1, 1))
    path = str(d / 't.trr')
    m.xdr.write_trr(path, pos, boxes, velocities_nm_ps=np.zeros_like(pos),
                    double=double)
    return [m.xdr.read_trr(path), Path(path).read_bytes(),
            [sorted(f.items()) for f in m.xdr.iter_trr_frames(path)]]


def trr_force_only_frame(m, d, double):
    forces = np.random.default_rng(4).normal(size=(5, 3))
    real, real_size = ('>d', 8) if double else ('>f', 4)
    title = b'GMX_trn_file'
    path = str(d / 'forces.trr')
    with open(path, 'wb') as f:
        f.write(struct.pack('>ii', m.xdr.TRR_MAGIC, len(title) + 1))
        f.write(struct.pack('>i', len(title)))
        f.write(title + b'\x00' * (-len(title) % 4))
        f.write(struct.pack('>13i', 0, 0, 0, 0, 0, 0, 0, 0, 0,
                            forces.size * real_size, 5, 7, 0))
        f.write(struct.pack(real, 0.25))
        f.write(struct.pack(real, 0.0))
        f.write(struct.pack(real.replace('>', '>%d' % forces.size),
                            *forces.reshape(-1)))
    return [sorted(f.items()) for f in m.xdr.iter_trr_frames(path)]


def xtc_tables(m, d):
    return [list(m.xdr.MAGICINTS), m.xdr.FIRSTIDX]


def xtc_small_system_exact_bytes(m, d):
    coords = np.array([[0.5, 0.25, 0.75], [1.0, -1.5, 2.25],
                       [-0.125, 0.0625, 3.5]])
    path = str(d / 'small.xtc')
    m.xdr.write_xtc(path, coords[None], boxes_nm=np.diag([2.0, 3, 4])[None],
                    times_ps=np.array([0.5]))
    return [Path(path).read_bytes(), m.xdr.read_xtc(path)]


def xtc_hand_derived_bitstreams(m, d):
    line = np.zeros((10, 3))
    line[:, 0] = np.arange(10, dtype=float)
    out = []
    for name, coords in (('line10', line), ('wide10', line * 14_000.0)):
        path = str(d / f'{name}.xtc')
        m.xdr.write_xtc(path, coords[None])
        out += [Path(path).read_bytes(), m.xdr.read_xtc(path)]
    assert out[0] == XTC_GOLD._line10_expected_bytes()
    return out


def xtc_compress_coords(m, d):
    """The codec's own functions on the bench-like and edge inputs."""
    rng = np.random.default_rng(5)
    out = []
    for coords in (rng.normal(1.5, 0.8, (40, 3)), _clustered(6)[0],
                   rng.uniform(-1, 1, (11, 3)) * 1e-3):
        packed = m.xdr._compress_coords(coords, 1000.0)
        out += [packed, m.xdr._decompress_coords(packed, 0, len(coords))]
    return out


def xtc_header_fields(m, d):
    coords = np.random.default_rng(7).normal(1.5, 0.8, (2, 40, 3))
    path = str(d / 'hdr.xtc')
    m.xdr.write_xtc(path, coords, boxes_nm=np.tile(np.eye(3) * 3.0,
                                                   (2, 1, 1)),
                    times_ps=np.array([0.0, 2.0]))
    return [Path(path).read_bytes(), m.xdr.scan_xtc_offsets(path)]


def golden_xtc(m, d):
    path = str(DATA / 'golden_waters.xtc')
    store = m.frames.XtcFrameStore(path)
    return [m.xdr.read_xtc(path), m.xdr.scan_xtc_offsets(path),
            np.asarray(store), store.dimensions, store.times,
            store._py_load(store._offsets)]


# --------------------------------------------------------------------------
# Lazy frame stores
# --------------------------------------------------------------------------

def _write_xdr(m, path, fmt, n_frames=6, n_mol=5, seed=8):
    pos = _clustered(seed, n_frames=n_frames, n_mol=n_mol)
    boxes = np.tile(np.diag([4.0, 4.0, 4.0]), (n_frames, 1, 1))
    write = m.xdr.write_xtc if fmt == 'xtc' else m.xdr.write_trr
    write(path, pos, boxes, np.arange(n_frames) * 0.004)


def lazy_frame_store(m, d, fmt):
    path = str(d / f't.{fmt}')
    _write_xdr(m, path, fmt)
    store = m.frames.open_frame_store(path)
    single = store[3]
    assert store[3] is single
    return [type(store).__name__, store.shape, store.dimensions, store.times,
            single, store[-1], store[[4, 1, 4]], store[1:5:2],
            np.asarray(store), store._py_load(store._offsets[[2, 0]])]


def system_from_xtc_lazy(m, d):
    xtc = str(d / 'waters.xtc')
    m.xdr.write_xtc(xtc, _clustered(9, n_frames=5, n_mol=2),
                    np.tile(np.eye(3) * 4.0, (5, 1, 1)))
    top = d / 'waters.top'
    top.write_text('\n[ moleculetype ]\nSOL 2\n[ atoms ]\n'
                   '1 OW 1 SOL OW 1 -0.8 15.999\n'
                   '2 HW 1 SOL HW1 1 0.4 1.008\n'
                   '3 HW 1 SOL HW2 1 0.4 1.008\n'
                   '[ settles ]\n1 1 0.1 0.16\n[ system ]\nwaters\n'
                   '[ molecules ]\nSOL 2\n')
    system = m.System.from_file(xtc, topology_path=str(top), lazy=True)
    dataset = m.traj.TrajectoryDataset(system)
    return [_sys(system), sorted(dataset[2].items())]


def get_batch_matches_itemwise(m, d):
    xtc = str(d / 't.xtc')
    m.xdr.write_xtc(xtc, _clustered(10, n_frames=6, n_mol=2),
                    np.tile(np.eye(3) * 4.0, (6, 1, 1)))
    top = m.Topology(names=['C'] * 6)
    store = m.frames.open_frame_store(xtc)
    out = []
    for positions in (np.asarray(store), store):
        dataset = m.traj.TrajectoryDataset(
            m.System(top, positions, dimensions=store.dimensions))
        dataset.add_aux('logw', np.arange(6.0))
        batch = dataset.get_batch([4, 1, 3])
        stacked = {k: np.stack([dataset[i][k] for i in (4, 1, 3)])
                   for k in dataset[0]}
        dataset.select_atoms([0, 2])
        out += [sorted(batch.items()), sorted(stacked.items()),
                sorted(dataset.get_batch([0]).items())]
    return out


def atom_count_mismatch_raises(m, d):
    m.xdr.write_xtc(str(d / 't.xtc'), _clustered(11, n_mol=2))
    top = d / 'bad.top'
    top.write_text('\n[ moleculetype ]\nX 2\n[ atoms ]\n1 C 1 MOL C1 1\n'
                   '[ system ]\nx\n[ molecules ]\nX 1\n')
    return [_error(lambda: m.System.from_file(str(d / 't.xtc'),
                                              topology_path=str(top)), d),
            _error(lambda: m.System.from_file(str(d / 't.xtc')), d),
            _error(lambda: m.System.from_file(str(d / 'x.pdb'), lazy=True),
                   d),
            _error(lambda: m.System.from_file(str(d / 'x.mol2')), d),
            _error(lambda: m.frames.open_frame_store(str(d / 'x.pdb')), d)]


# --------------------------------------------------------------------------
# DCD (tests/io/test_dcd.py)
# --------------------------------------------------------------------------

def _dcd(d, name='traj.dcd', seed=0, shape=(5, 7, 3), cells=True,
         namnf=0, cell=(20.0, 21.0, 22.0, 90.0, 90.0, 90.0)):
    positions = np.random.default_rng(seed).normal(
        size=shape).astype(np.float32)
    path = str(d / name)
    DCD.write_dcd(path, positions,
                  np.tile(cell, (shape[0], 1)) if cells else None, namnf)
    return path


def dcd_reads(m, d):
    path = _dcd(d)
    store = m.frames.DcdFrameStore(path)
    return [m.dcd.read_dcd_header(path), m.dcd.read_dcd(path),
            m.dcd.read_dcd(path, frame_indices=[4, 0, 2]),
            m.dcd.read_dcd(path, frame_indices=np.arange(5)[::2]),
            m.dcd._py_read_frames(path, np.arange(5)),
            m.dcd.read_dcd_cells(path), store.shape, store.dimensions,
            store.times, store[2], np.asarray(store)]


def dcd_no_cell(m, d):
    path = _dcd(d, 'nocell.dcd', seed=1, shape=(3, 4, 3), cells=False)
    return [m.dcd.read_dcd(path), m.frames.DcdFrameStore(path).dimensions]


def dcd_charmm_cosine_angles(m, d):
    path = _dcd(d, 'charmm.dcd', seed=2, shape=(2, 3, 3),
                cell=(20.0, 21.0, 22.0, 0.0, 0.0, 0.5))
    return [m.dcd.read_dcd(path), m.frames.DcdFrameStore(path).dimensions]


def dcd_errors(m, d):
    fixed = _dcd(d, 'fixed.dcd', seed=3, shape=(2, 4, 3), cells=False,
                 namnf=2)
    payload = Path(_dcd(d, 'full.dcd', seed=4, shape=(2, 4, 3),
                        cells=False)).read_bytes()
    out = [_error(lambda: m.dcd.read_dcd_header(fixed), d)]
    for cut in (2, 6, 40, 90):
        trunc = d / f'trunc{cut}.dcd'
        trunc.write_bytes(payload[:cut])
        out.append(_error(lambda: m.dcd.read_dcd_header(str(trunc)), d))
    return out


# --------------------------------------------------------------------------
# AMBER NetCDF (tests/io/test_netcdf.py)
# --------------------------------------------------------------------------

def _nc_header(nc):
    return dict(version=nc.version, numrecs=nc.numrecs,
                recsize=nc.recsize, dims=nc.dims,
                attrs=sorted(nc.attrs.items()),
                variables=[
                    (name, v.dimids, v.nc_type, v.vsize, v.begin, v.shape,
                     v.is_record, sorted(v.attrs.items()))
                    for name, v in nc.variables.items()])


def netcdf_golden(m, d, name):
    path = str(DATA / name)
    nc = m.netcdf.read_amber_netcdf_header(path)
    store = m.frames.open_frame_store(path)
    return [_nc_header(nc)] + [nc.read(v) for v in (
        'coordinates', 'time', 'cell_lengths', 'cell_angles')] + [
        nc.read('coordinates', records=np.array([3, 0])),
        type(store).__name__, store.shape, store[2], store[-1],
        store[[0, 4]], store.times, store.dimensions]


def netcdf_system_from_file(m, d):
    pdb = d / 'topo.pdb'
    pdb.write_text('\n'.join(
        f'ATOM  {i + 1:5d}  C{i + 1:<2d} MOL A   1    '
        f'{0.0:8.3f}{0.0:8.3f}{0.0:8.3f}  1.00  0.00           C'
        for i in range(7)) + '\nEND\n')
    path = str(DATA / 'golden_amber.nc')
    return [_sys(m.System.from_file(path, topology_path=str(pdb),
                                    lazy=lazy)) for lazy in (True, False)]


def netcdf_scale_factor(m, d):
    scipy_io = pytest.importorskip('scipy.io')
    path = d / 'scaled.nc'
    with scipy_io.netcdf_file(str(path), 'w') as f:
        f.Conventions = 'AMBER'
        f.createDimension('frame', None)
        f.createDimension('spatial', 3)
        f.createDimension('atom', 3)
        v = f.createVariable('coordinates', 'f', ('frame', 'atom', 'spatial'))
        v.units = 'angstrom'
        v.scale_factor = 0.5
        v[:] = np.arange(18, dtype=np.float32).reshape(2, 3, 3)
    return np.asarray(m.frames.NetCDFFrameStore(str(path)))


def netcdf_writer(m, d, cell):
    rng = np.random.default_rng(11)
    coords = rng.uniform(-15, 15, size=(4, 6, 3)).astype(np.float32)
    path = d / 'out.nc'
    m.netcdf.write_amber_netcdf(
        str(path), coords,
        times=np.array([0.5, 1.0, 1.5, 2.0], dtype=np.float32),
        dimensions=np.tile([25.0, 26.0, 27.0, 90.0, 90.0, 90.0], (4, 1))
        if cell else None)
    store = m.frames.NetCDFFrameStore(str(path))
    return [path.read_bytes(), np.asarray(store), store.times,
            store.dimensions]


def netcdf_cdf2(m, d):
    old = m.netcdf._CDF1_MAX_BYTES
    m.netcdf._CDF1_MAX_BYTES = 1024
    try:
        rng = np.random.default_rng(9)
        path = d / 'big.nc'
        m.netcdf.write_amber_netcdf(
            str(path), rng.normal(0, 5, size=(3, 17, 3)).astype(np.float32),
            times=np.asarray([0.5, 1.0, 1.5], dtype=np.float32),
            dimensions=np.tile([20.0, 21.0, 22.0, 90.0, 90.0, 90.0], (3, 1)))
    finally:
        m.netcdf._CDF1_MAX_BYTES = old
    nc = m.netcdf.read_amber_netcdf_header(str(path))
    return [path.read_bytes(), _nc_header(nc), nc.read('coordinates')]


def netcdf_errors(m, d):
    scipy_io = pytest.importorskip('scipy.io')
    other = d / 'other.nc'
    with scipy_io.netcdf_file(str(other), 'w') as f:
        f.Conventions = 'CF-1.8'
        f.createDimension('frame', None)
        f.createDimension('spatial', 3)
        f.createDimension('atom', 2)
        v = f.createVariable('coordinates', 'f', ('frame', 'atom', 'spatial'))
        v[:] = np.zeros((1, 2, 3), dtype=np.float32)
    (d / 'fake.nc').write_bytes(b'\x89HDF\r\n\x1a\n' + b'\x00' * 64)
    (d / 'noise.nc').write_bytes(b'NOPE' + b'\x00' * 64)
    (d / 'trunc.nc').write_bytes(b'CDF\x01\x00\x00')
    return [_error(lambda: m.netcdf.read_amber_netcdf_header(str(other)), d)
            ] + [_error(lambda n=n: m.netcdf.NetCDFFile.open(str(d / n)), d)
                 for n in ('fake.nc', 'noise.nc', 'trunc.nc')]


# --------------------------------------------------------------------------
# Topology files (tests/io/test_formats.py, test_psf_restart.py)
# --------------------------------------------------------------------------

def prmtop(m, d):
    path = d / 'sys.prmtop'
    path.write_text(FORMATS.PRMTOP)
    old = d / 'old.prmtop'
    old.write_text(FORMATS.PRMTOP.split('%FLAG ATOMIC_NUMBER')[0]
                   + FORMATS.PRMTOP.split(
                       '%FORMAT(10I8)\n       6       6       8       1'
                       '       1\n')[1])
    chain = d / 'chain.prmtop'
    chain.write_text(FORMATS.CHAIN_PRMTOP)
    return [_top(m.topfiles.read_prmtop(str(p))) for p in (path, old, chain)
            ] + [_top(m.traj.load_topology(str(path)))]


def gromacs_top(m, d):
    (d / 'mol.itp').write_text(
        '\n[ moleculetype ]\nMOL 3\n[ atoms ]\n'
        '1 c3 1 MOL C1 1 -0.1 12.011\n2 c3 1 MOL C2 1 -0.1 12.011\n'
        '3 hc 1 MOL H1 1 0.05 1.008\n[ bonds ]\n1 2 1\n1 3 1\n')
    top = d / 'system.top'
    top.write_text(
        '\n#include "amber99.ff/forcefield.itp"\n#include "mol.itp"\n'
        '[ moleculetype ]\nSOL 2\n[ atoms ]\n1 OW 1 SOL OW 1\n'
        '2 HW 1 SOL HW1 1\n3 HW 1 SOL HW2 1\n[ settles ]\n'
        '1 1 0.09572 0.15139\n[ system ]\nSolvated MOL\n[ molecules ]\n'
        'MOL 1\nSOL 2\n')
    bad = d / 'bad.top'
    bad.write_text('[ system ]\nx\n[ molecules ]\nGHOST 3\n')
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        result = [_top(m.topfiles.read_gromacs_top(str(top))),
                  _top(m.traj.load_topology(str(top)))]
    return result + [[str(w.message).replace(str(d), '<dir>')
                      for w in caught],
                     _error(lambda: m.topfiles.read_gromacs_top(str(bad)), d)]


_IFDEF_BODY = """
[ moleculetype ]
SOL 2
[ atoms ]
1 OW 1 SOL OW 1 -0.8 15.999
2 HW 1 SOL HW1 1 0.4 1.008
3 HW 1 SOL HW2 1 0.4 1.008
#ifndef FLEXIBLE
[ settles ]
1 1 0.1 0.16
#else
[ bonds ]
1 2
1 3
#endif
[ system ]
water
[ molecules ]
SOL 1
"""

_IF_ELIF_BODY = """
[ moleculetype ]
MOL 2
[ atoms ]
1 C 1 MOL C1 1 0.0 12.011
2 C 1 MOL C2 1 0.0 12.011
3 C 1 MOL C3 1 0.0 12.011
#ifndef OUTER
#if VARIANT_A
[ bonds ]
1 2
#elif defined(VARIANT_B)
[ bonds ]
1 3
#else
[ bonds ]
2 3
#endif
#endif
[ system ]
mol
[ molecules ]
MOL 1
"""


def gromacs_top_conditionals(m, d):
    texts = [_IFDEF_BODY, '#define FLEXIBLE\n' + _IFDEF_BODY,
             _IF_ELIF_BODY, '#define VARIANT_A\n' + _IF_ELIF_BODY,
             '#define VARIANT_B\n' + _IF_ELIF_BODY,
             '#define OUTER\n#define VARIANT_A\n' + _IF_ELIF_BODY,
             _IF_ELIF_BODY.replace('#if VARIANT_A', '#if (X + 1) > 2'),
             '#define OUTER\n' + _IF_ELIF_BODY.replace('#if VARIANT_A',
                                                       '#if (X + 1) > 2'),
             _IF_ELIF_BODY.replace('#if VARIANT_A', '#if 1'),
             _IF_ELIF_BODY.replace('#if VARIANT_A', '#if 0')]
    out = []
    for i, text in enumerate(texts):
        path = d / f'c{i}.top'
        path.write_text(text)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            bonds = m.topfiles.read_gromacs_top(str(path)).bonds
        out.append([bonds, [str(w.message).replace(str(d), '<dir>')
                            for w in caught]])
    return out


def guess_bonds(m, d):
    positions = np.array([[0.0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0],
                          [5.0, 5, 5]])
    rng = np.random.default_rng(12)
    cloud = rng.uniform(0, 6, (30, 3))
    return [m.topfiles.guess_bonds(positions, ['O', 'H', 'H', 'O']),
            m.topfiles.guess_bonds(cloud, ['C', 'H', 'O', 'N', 'S'] * 6),
            m.topfiles.guess_bonds(cloud, ['C'] * 30, tolerance=0.2,
                                   min_distance=0.8)]


def psf(m, d):
    out = []
    for i, text in enumerate((RESTART.PSF_CLASSIC, RESTART.PSF_EXT)):
        path = d / f'w{i}.psf'
        path.write_text(text)
        out += [_top(m.topfiles.read_psf(str(path))),
                _top(m.traj.load_topology(str(path)))]
    return out


def psf_errors(m, d):
    bad = {
        'non_psf': 'ATOM ...\n',
        'bonds': ('PSF\n\n       1 !NATOM\n'
                  '       1 A    1    RES  X    XT    0.0    12.011    0\n'
                  '\n       2 !NBOND\n       1       1\n'),
        'zero': ('PSF\n\n       2 !NATOM\n'
                 '       1 A    1    RES  X    XT    0.0    12.011    0\n'
                 '       2 A    1    RES  Y    YT    0.0    12.011    0\n'
                 '\n       1 !NBOND\n       0       2\n'),
        'atoms': ('PSF\n\n       3 !NATOM\n'
                  '       1 A    1    RES  X    XT    0.0    12.011    0\n'),
    }
    out = []
    for name, text in bad.items():
        path = d / f'{name}.psf'
        path.write_text(text)
        out.append(_error(lambda p=path: m.topfiles.read_psf(str(p)), d))
    return out


# --------------------------------------------------------------------------
# AMBER restarts (tests/io/test_psf_restart.py)
# --------------------------------------------------------------------------

def inpcrd(m, d):
    rng = np.random.default_rng(13)
    pos = rng.normal(0, 5, size=(7, 3))
    two = np.array([[0.0, 0.0, 0.0], [1.5, 0.0, 0.0]])
    texts = {
        'plain': RESTART.format_inpcrd(pos),
        'full': RESTART.format_inpcrd(pos, velocities=rng.normal(size=(7, 3)),
                                      box=[30, 31, 32, 90, 90, 120],
                                      time=12.5),
        'box': RESTART.format_inpcrd(pos, box=[30, 31, 32, 90, 90, 90]),
        'negative': RESTART.format_inpcrd(-np.abs(pos) * 20.0),
        'boxish': RESTART.format_inpcrd(two, box=[18.0, 18, 18, 90, 90, 90]),
        'velish': RESTART.format_inpcrd(two, velocities=np.array(
            [[0.31, -0.52, 0.11], [-0.27, 0.44, -0.63]])),
    }
    out = []
    for name, text in texts.items():
        path = d / f'{name}.rst7'
        path.write_text(text)
        out += [m.restart.read_inpcrd(str(path)),
                m.restart.read_amber_restart(str(path))]
    trailing = d / 'trailing.inpcrd'
    trailing.write_text(RESTART.format_inpcrd(pos) + '     1.0     2.0\n')
    return out + [_error(lambda: m.restart.read_inpcrd(str(trailing)), d)]


def ncrst(m, d):
    pytest.importorskip('scipy.io')
    rng = np.random.default_rng(3)
    path = d / 'x.ncrst'
    RESTART.write_scipy_ncrst(path, rng.normal(0, 8, size=(7, 3)),
                              box=np.array([30.0, 31, 32, 90, 90, 120]),
                              time=7.75)
    traj = d / 'traj.nc'
    m.netcdf.write_amber_netcdf(str(traj),
                                np.zeros((2, 3, 3), dtype=np.float32))
    return [m.restart.read_ncrst(str(path)),
            m.restart.read_amber_restart(str(path)),
            _error(lambda: m.restart.read_ncrst(str(traj)), d)]


def system_from_restart(m, d):
    path = d / 'waters.psf'
    path.write_text(RESTART.PSF_CLASSIC)
    rst = d / 'x.rst7'
    rst.write_text(RESTART.format_inpcrd(
        np.random.default_rng(4).normal(0, 4, size=(6, 3)),
        box=[25, 25, 25, 90, 90, 90], time=3.0))
    small = d / 'x.inpcrd'
    small.write_text(RESTART.format_inpcrd(np.zeros((2, 3))))
    return [_sys(m.System.from_file(str(rst), topology_path=str(path))),
            _error(lambda: m.System.from_file(str(small)), d),
            _error(lambda: m.System.from_file(str(small),
                                              topology_path=str(path)), d)]


# --------------------------------------------------------------------------
# Writers and the text readers (tests/io/test_formats.py)
# --------------------------------------------------------------------------

def write_text_formats(m, d, triclinic):
    system = _writer_system(m, triclinic=triclinic)
    out = []
    for ext, write, read in (('pdb', m.writers.write_pdb, m.traj.read_pdb),
                             ('gro', m.writers.write_gro, m.traj.read_gro),
                             ('xyz', m.writers.write_xyz, m.traj.read_xyz)):
        path = d / f'out.{ext}'
        write(str(path), system)
        out += [path.read_bytes(), _sys(read(str(path))),
                _sys(m.System.from_file(str(path)))]
    return out


def write_binary_formats(m, d):
    """``System.save`` to XTC, TRR and NetCDF, and the mapped override."""
    system = _writer_system(m)
    mapped = np.asarray(system.positions, np.float64).reshape(
        system.n_frames, -1) + 1.5
    out = []
    for ext in ('xtc', 'trr', 'nc', 'dcd_never'):
        path = d / f'out.{ext}'
        if ext == 'dcd_never':
            out.append(_error(lambda: system.save(str(path)), d))
            continue
        system.save(str(path))
        system.save(str(d / f'mapped.{ext}'), positions=mapped)
        out += [path.read_bytes(), (d / f'mapped.{ext}').read_bytes()]
    return out


def write_edge_cases(m, d):
    lipid = m.System(m.Topology(names=['C1', 'C2'], elements=['C', 'C'],
                                resnames=['POPC', 'POPC'], resids=[1, 1]),
                     np.ones((1, 2, 3)))
    lipid.save(str(d / 'lipid.pdb'))
    one = _writer_system(m, n_frames=1)
    one_frame = np.asarray(one.positions[0], np.float64)
    one.save(str(d / 'one.xyz'), positions=one_frame + 0.5)
    mapped = np.tile(np.asarray(one.positions[0]).reshape(1, -1),
                     (3, 1)) + np.arange(3)[:, None]
    one.save(str(d / 'mapped.gro'), positions=mapped)
    bonds = [(9998, 9999), (9999, 10000), (10000, 10001)]
    big = m.System(m.Topology(names=['C'] * 10002, bonds=bonds),
                   np.zeros((1, 10002, 3), dtype=np.float32))
    big.save(str(d / 'big.pdb'))
    return [_sys(m.traj.read_pdb(str(d / 'lipid.pdb'))),
            _sys(m.traj.read_xyz(str(d / 'one.xyz'))),
            _sys(m.traj.read_gro(str(d / 'mapped.gro'))),
            (d / 'big.pdb').read_bytes(),
            m.traj.read_pdb(str(d / 'big.pdb')).topology.bonds,
            _error(lambda: one.save(str(d / 'bad.xyz'),
                                    positions=np.ones((7, 11))), d),
            _error(lambda: one.save(str(d / 'bad.gro'), positions=mapped,
                                    dimensions=np.tile(one.dimensions,
                                                       (2, 1))), d),
            _error(lambda: one.save(str(d / 'out.nope')), d)]


def box_conversions(m, d):
    dims = np.array([[20.0, 30.0, 40.0, 80.0, 95.0, 120.0],
                     [10.0, 10.0, 10.0, 90.0, 90.0, 90.0]])
    vectors = m.traj.dimensions_to_box_vectors(dims)
    v = np.array([[2.0, 0.0, 0.0], [0.5, 1.9, 0.0], [0.3, 0.2, 2.1]])
    gro = d / 'tri.gro'
    gro.write_text(
        'triclinic\n    2\n'
        '    1MOL     C1    1   0.100   0.200   0.300\n'
        '    1MOL     C2    2   0.400   0.500   0.600\n'
        f'   {v[0, 0]:.5f}   {v[1, 1]:.5f}   {v[2, 2]:.5f}   {v[0, 1]:.5f}'
        f'   {v[0, 2]:.5f}   {v[1, 0]:.5f}   {v[1, 2]:.5f}   {v[2, 0]:.5f}'
        f'   {v[2, 1]:.5f}\n')
    return [vectors, m.traj.box_vectors_to_dimensions(vectors),
            _sys(m.traj.read_gro(str(gro)))]


def pdb_records(m, d):
    """A hand-written PDB: MODELs, CRYST1, HETATM, element columns partly
    missing, CONECT records."""
    atoms = [('ATOM  ', 'N1', 'ALA', 1, 'N'), ('ATOM  ', 'CA', 'ALA', 1, ''),
             ('HETATM', 'OW', 'HOH', 2, 'O'), ('HETATM', 'CL1', 'CL', 3, '')]
    lines = ['CRYST1   30.000   31.000   32.000  90.00  90.00 120.00 P 1'
             '           1']
    for model in range(2):
        lines.append(f'MODEL     {model + 1:4d}')
        for i, (rec, name, res, resid, elem) in enumerate(atoms):
            x, y, z = 1.0 + i + model, 2.0 - i, 0.5 * i
            lines.append(f'{rec}{i + 1:5d} {name:<4s} {res:<3s} A{resid:4d}'
                         f'    {x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00'
                         f'          {elem:>2s}')
        lines.append('ENDMDL')
    lines += ['CONECT    1    2', 'CONECT    2    1    3', 'END']
    path = d / 'hand.pdb'
    path.write_text('\n'.join(lines) + '\n')
    return _sys(m.traj.read_pdb(str(path)))


# --------------------------------------------------------------------------
# From an MDAnalysis Universe, duck-typed (tests/io/test_formats.py)
# --------------------------------------------------------------------------

def from_universe(m, d):
    rng = np.random.default_rng(14)
    pos = rng.normal(0, 1, (3, 4, 3)).astype(np.float32)
    box = np.array([10.0, 11.0, 12.0, 90.0, 90.0, 90.0], np.float32)
    atoms = FORMATS._FakeAtoms(
        4, names=np.array(['O', 'H1', 'H2', 'C'], object),
        elements=np.array(['O', 'H', 'H', 'C'], object),
        resnames=np.array(['SOL', 'SOL', 'SOL', 'MOL'], object),
        resids=np.array([1, 1, 1, 2]),
        masses=np.array([15.999, 1.008, 1.008, 12.011]))
    universe = FORMATS._FakeUniverse(
        atoms, [FORMATS._FakeTimestep(pos[i], box, 0.5 * i)
                for i in range(3)],
        bonds=FORMATS._FakeBonds([[0, 1], [0, 2]]))
    system = m.System.from_universe(universe)

    class Reused:
        """Iterates by mutating one shared timestep in place."""

        def __iter__(self):
            ts = FORMATS._FakeTimestep(np.empty((4, 3), np.float32),
                                       np.empty(6, np.float32), 0.0)
            for i in range(3):
                ts.positions[:] = pos[i]
                ts.dimensions[:] = box + i
                ts.time = float(i)
                yield ts

    class Bare:
        def __init__(self, p):
            self.positions = p
            self.dimensions = None

    small = FORMATS._FakeAtoms(2, elements=np.array(['C', 'H'], object))
    zero = np.zeros(6, np.float32)
    degenerate = np.array([0, 0, 0, 90, 90, 90], np.float32)
    T = FORMATS._FakeTimestep
    U = FORMATS._FakeUniverse
    return [
        _sys(system), system.select_atoms('resname MOL'),
        _sys(m.System.from_universe(U(
            FORMATS._FakeAtoms(4, elements=atoms.elements), Reused()))),
        _sys(m.System.from_universe(U(small, [T(pos[0, :2], zero, 0),
                                              T(pos[1, :2], zero, 1)]))),
        _sys(m.System.from_universe(U(small, [T(pos[0, :2], degenerate, 0),
                                              T(pos[1, :2], zero, 1)]))),
        _sys(m.System.from_universe(U(small, [Bare(p[:2]) for p in pos]))),
        _error(lambda: m.System.from_universe(U(small, [])), d),
        _error(lambda: m.System.from_universe(U(small, [
            T(pos[0, :2], box, 0.0), T(pos[1, :2], None, 1.0)])), d)]


# --------------------------------------------------------------------------

CASES = [
    *[functools.partial(xtc_roundtrip, n_mol=n) for n in (1, 2, 20)],
    xtc_wide_coordinate_range, xtc_too_large_raises,
    *[functools.partial(trr_roundtrip, double=x) for x in (False, True)],
    *[functools.partial(trr_force_only_frame, double=x)
      for x in (False, True)],
    xtc_tables, xtc_small_system_exact_bytes, xtc_hand_derived_bitstreams,
    xtc_compress_coords, xtc_header_fields, golden_xtc,
    *[functools.partial(lazy_frame_store, fmt=f) for f in ('xtc', 'trr')],
    system_from_xtc_lazy, get_batch_matches_itemwise,
    atom_count_mismatch_raises,
    dcd_reads, dcd_no_cell, dcd_charmm_cosine_angles, dcd_errors,
    *[functools.partial(netcdf_golden, name=n)
      for n in ('golden_amber.nc', 'golden_amber_v2.nc')],
    netcdf_system_from_file, netcdf_scale_factor,
    *[functools.partial(netcdf_writer, cell=c) for c in (True, False)],
    netcdf_cdf2, netcdf_errors,
    prmtop, gromacs_top, gromacs_top_conditionals, guess_bonds, psf,
    psf_errors, inpcrd, ncrst, system_from_restart,
    *[functools.partial(write_text_formats, triclinic=t)
      for t in (False, True)],
    write_binary_formats, write_edge_cases, box_conversions, pdb_records,
    from_universe,
]


def _case_id(case):
    if isinstance(case, functools.partial):
        return case.func.__name__ + ''.join(
            f'-{v}' for v in case.keywords.values())
    return case.__name__


@pytest.mark.parametrize('case', CASES, ids=_case_id)
def test_same_as_jax(case, tmp_path):
    port, ref = tmp_path / 'port', tmp_path / 'jax'
    port.mkdir()
    ref.mkdir()
    assert_same(case(PORT, port), case(JAX, ref))


# --------------------------------------------------------------------------
# Files that one package wrote, read by the other
# --------------------------------------------------------------------------

def _write_all(m, d):
    system = _writer_system(m, n_frames=4, triclinic=True)
    for ext in ('pdb', 'gro', 'xyz', 'xtc', 'trr', 'nc'):
        system.save(str(d / f'x.{ext}'))
    DCD.write_dcd(str(d / 'x.dcd'),
                  np.asarray(system.positions, np.float32),
                  system.dimensions)


def _read_all(m, d):
    out = [_sys(m.System.from_file(str(d / f'x.{ext}')))
           for ext in ('pdb', 'gro', 'xyz')]
    for ext in ('xtc', 'trr', 'nc', 'dcd'):
        for lazy in (False, True):
            out.append(_sys(m.System.from_file(
                str(d / f'x.{ext}'), topology_path=str(d / 'x.pdb'),
                lazy=lazy)))
    return out


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_read_files_the_other_package_wrote(writer, tmp_path):
    _write_all(PORT if writer == 'port' else JAX, tmp_path)
    assert_same(_read_all(PORT, tmp_path), _read_all(JAX, tmp_path))


def test_both_writers_write_the_same_bytes(tmp_path):
    for m, name in ((PORT, 'port'), (JAX, 'jax')):
        (tmp_path / name).mkdir()
        _write_all(m, tmp_path / name)
    for ext in ('pdb', 'gro', 'xyz', 'xtc', 'trr', 'nc'):
        assert ((tmp_path / 'port' / f'x.{ext}').read_bytes()
                == (tmp_path / 'jax' / f'x.{ext}').read_bytes()), ext


# --------------------------------------------------------------------------
# The golden files of tests/data
# --------------------------------------------------------------------------

def test_golden_files_against_expected_values():
    expected = dict(np.load(DATA / 'golden_amber_expected.npz'))
    for name in ('golden_amber.nc', 'golden_amber_v2.nc'):
        nc = port_netcdf.read_amber_netcdf_header(str(DATA / name))
        for key, var in (('coordinates', 'coordinates'), ('times', 'time'),
                         ('cell_lengths', 'cell_lengths'),
                         ('cell_angles', 'cell_angles')):
            np.testing.assert_array_equal(nc.read(var), expected[key])
        store = port_frames.open_frame_store(str(DATA / name))
        np.testing.assert_array_equal(np.asarray(store),
                                      expected['coordinates'])
    coords, boxes, times = XTC_GOLD._golden_system()
    got, got_boxes, got_times = port_xdr.read_xtc(
        str(DATA / 'golden_waters.xtc'))
    np.testing.assert_allclose(got, coords, atol=0.5001e-3)
    np.testing.assert_array_equal(got_boxes, boxes)
    np.testing.assert_array_equal(got_times,
                                  times.astype(np.float32).astype(float))


# --------------------------------------------------------------------------
# Native decoder against the pure-Python one
# --------------------------------------------------------------------------

needs_compiler = pytest.mark.skipif(
    not port_native.native_available(),
    reason='the native trajectory library did not build here (no g++?)')


@needs_compiler
@pytest.mark.parametrize('fmt', ['xtc', 'trr', 'dcd'])
def test_native_against_pure_python(fmt, tmp_path, monkeypatch):
    """The native and the pure-Python decoder of the port, on the same
    file. TRR and DCD carry float32 coordinates, so both give the same
    bits. The XTC decoders recover the same quantized integers; their
    floats may differ in the last place, because the native one multiplies
    by a float32 reciprocal of the precision, as the JAX package's does."""
    path = str(tmp_path / f't.{fmt}')
    if fmt == 'dcd':
        DCD.write_dcd(path, (_clustered(15, n_frames=6) * 10).astype(
            np.float32), np.tile([40.0, 40, 40, 90, 90, 90], (6, 1)))
    else:
        _write_xdr(PORT, path, fmt, n_frames=6, n_mol=20, seed=15)
    native = np.asarray(port_frames.open_frame_store(path))
    native_again = port_frames.open_frame_store(path)[[5, 0, 3]]
    monkeypatch.setattr(port_frames, 'native_lib', lambda: None)
    monkeypatch.setattr(port_dcd, '_native_lib', lambda: None)
    python_store = port_frames.open_frame_store(path)
    python = np.asarray(python_store)
    np.testing.assert_array_equal(native_again, native[[5, 0, 3]])
    if fmt == 'xtc':
        quantized = port_xdr.read_xtc(path)[0] * 1000.0
        np.testing.assert_array_equal(
            np.round(native.astype(np.float64) * 100.0), np.round(quantized))
        np.testing.assert_array_equal(python * np.float32(0.1),
                                      (quantized / 1000.0).astype(np.float32)
                                      * np.float32(10.0) * np.float32(0.1))
        assert np.abs(native - python).max() <= 1e-5 * np.abs(python).max()
    else:
        np.testing.assert_array_equal(native, python)


@needs_compiler
def test_native_decoders_of_both_packages_agree(tmp_path):
    """The port's copy of trajio.cpp decodes as the JAX package's does."""
    for fmt in ('xtc', 'trr'):
        path = str(tmp_path / f't.{fmt}')
        _write_xdr(PORT, path, fmt, n_frames=5, n_mol=30, seed=16)
        np.testing.assert_array_equal(
            np.asarray(port_frames.open_frame_store(path)),
            np.asarray(jax_frames.open_frame_store(path)))
    assert port_native.SOURCE.read_bytes().replace(
        b'tfep_tpu_torch/', b'tfep_tpu/') == (
            ROOT / 'tfep_tpu' / 'native' / 'trajio.cpp').read_bytes()


def test_loader_builds_the_ports_source_into_build_native(tmp_path,
                                                          monkeypatch):
    """The build command names the port's source (``test_torch_guard.py``
    checks where it and the build directory are) and the library lands in
    the build directory under its source's digest."""
    assert port_native.library_path().parent == port_native.BUILD_DIR
    commands = []
    real_run = subprocess.run

    def run(cmd, **kwargs):
        commands.append(cmd)
        return real_run(cmd, **kwargs)

    monkeypatch.setattr(port_native.subprocess, 'run', run)
    monkeypatch.setattr(port_native, 'BUILD_DIR', tmp_path / 'build_native')
    monkeypatch.setattr(port_native, '_TRIED', False)
    monkeypatch.setattr(port_native, '_LIB', None)
    monkeypatch.setattr(port_native, '_ERROR', None)
    lib = port_native.native_lib()
    assert len(commands) == 1 and commands[0][0] == 'g++'
    assert commands[0][-1] == str(port_native.SOURCE)
    assert not any('tfep_tpu/' in str(arg) for arg in commands[0])
    if lib is None:
        assert port_native.native_build_error()
    else:
        built = list((tmp_path / 'build_native').iterdir())
        assert [p.name for p in built] == [port_native.library_path().name]
        assert port_native.native_build_error() is None
    # A second call neither builds nor loads again.
    assert port_native.native_lib() is lib and len(commands) == 1


def test_loader_reports_a_failed_build(tmp_path, monkeypatch):
    monkeypatch.setattr(port_native, 'SOURCE', tmp_path / 'broken.cpp')
    (tmp_path / 'broken.cpp').write_text('this is not C++\n')
    monkeypatch.setattr(port_native, 'BUILD_DIR', tmp_path / 'build_native')
    monkeypatch.setattr(port_native, '_TRIED', False)
    monkeypatch.setattr(port_native, '_LIB', None)
    monkeypatch.setattr(port_native, '_ERROR', None)
    assert port_native.native_lib() is None
    assert not port_native.native_available()
    assert port_native.native_build_error()
    assert not list((tmp_path / 'build_native').glob('*.so'))


# --------------------------------------------------------------------------
# Lazy systems
# --------------------------------------------------------------------------

@pytest.mark.parametrize('fmt', ['xtc', 'trr', 'dcd', 'nc'])
def test_lazy_system_reads_only_what_is_asked(fmt, tmp_path, monkeypatch):
    """``System.from_file(lazy=True)`` gives what eager reading gives, and
    neither ``System`` nor the dataset reads the whole trajectory: only
    the frames of each batch are decoded, and never through the LRU cache
    that single-frame indexing uses."""
    system = _writer_system(PORT, n_frames=12, triclinic=True)
    system.save(str(tmp_path / 'top.pdb'))
    path = str(tmp_path / f'x.{fmt}')
    if fmt == 'dcd':
        DCD.write_dcd(path, np.asarray(system.positions, np.float32),
                      system.dimensions)
    else:
        system.save(path)
    eager = port_traj.System.from_file(path, topology_path=str(
        tmp_path / 'top.pdb'))

    decoded = []
    store_cls = type(port_frames.open_frame_store(path))
    load = store_cls._load_frames

    def counting(self, frame_indices):
        decoded.append(list(frame_indices))
        return load(self, frame_indices)

    monkeypatch.setattr(store_cls, '_load_frames', counting)
    monkeypatch.setattr(store_cls, '__array__', None)
    lazy = port_traj.System.from_file(
        path, topology_path=str(tmp_path / 'top.pdb'), lazy=True)
    assert isinstance(lazy.positions, port_frames.FrameStore)
    assert decoded == []
    assert_same(_top(lazy.topology), _top(eager.topology))
    np.testing.assert_array_equal(lazy.dimensions, eager.dimensions)
    np.testing.assert_array_equal(lazy.times, eager.times)

    dataset = port_traj.TrajectoryDataset(lazy)
    dataset.select_atoms('name C1 O1')
    batch = dataset.get_batch([7, 2, 9])
    assert decoded == [[7, 2, 9]]
    assert lazy.positions._cache == {}
    eager_dataset = port_traj.TrajectoryDataset(eager)
    eager_dataset.select_atoms('name C1 O1')
    assert_same(sorted(batch.items()),
                sorted(eager_dataset.get_batch([7, 2, 9]).items()))
    assert_same(sorted(dataset[4].items()), sorted(eager_dataset[4].items()))
    assert decoded == [[7, 2, 9], [4]]
    assert list(lazy.positions._cache) == [4]


def test_mixedmaf_trains_from_xtc_prmtop(tmp_path):
    """The port's counterpart of ``tests/io/test_formats.py``'s: the
    flagship map builds its Z-matrix from a prmtop bond graph and trains
    on lazy XTC frames."""
    import torch

    from tfep_tpu_torch.app import MixedMAFMap, Trainer
    from tfep_tpu_torch.units import ureg

    prmtop = tmp_path / 'chain.prmtop'
    prmtop.write_text(FORMATS.CHAIN_PRMTOP)
    base = 0.1 * np.array([
        [0.0, 0.0, 0.0], [1.5, 0.0, 0.0], [2.25, 1.3, 0.0], [1.5, 2.2, 1.1],
        [-0.5, -0.7, 0.6], [1.9, -0.6, 0.8], [3.3, 1.4, 0.4],
        [1.0, 3.0, 0.4]])
    pos_nm = base[None] + 0.005 * np.random.default_rng(7).normal(
        size=(12, 8, 3))
    xtc = str(tmp_path / 'chain.xtc')
    port_xdr.write_xtc(xtc, pos_nm, precision=100000.0)

    class Potential:
        energy_unit = None

        def __call__(self, x, cell=None):
            return torch.sum(x, dim=-1)

    tfep_map = MixedMAFMap(
        potential_energy_func=Potential(), temperature=300.0 * ureg.kelvin,
        coordinates_file_path=xtc, topology_file_path=str(prmtop),
        lazy_trajectory=True, batch_size=6,
        tfep_logger_dir_path=str(tmp_path / 'logs'), n_maf_layers=1,
        device='cpu', dtype=torch.float64)
    assert isinstance(tfep_map._system.positions, port_frames.XtcFrameStore)
    assert tfep_map._system.topology.bonds.tolist() == [
        [0, 1], [0, 4], [1, 2], [1, 5], [2, 3], [2, 6], [3, 7]]
    trainer = Trainer(save_dir=None, max_epochs=1, shuffle=False)
    trainer.fit(tfep_map)
    assert trainer.global_step == 2
    logged = tfep_map.tfep_logger.read_train_tensors(epoch_idx=0)
    assert np.all(np.isfinite(logged['potential']))
    np.testing.assert_array_equal(logged['dataset_sample_index'],
                                  np.arange(12))
