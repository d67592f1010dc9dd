"""The port's six engine wrappers against the JAX package's, on fakes and
golden files.

Mirrors ``tests/potentials/test_mock_engines.py`` and
``tests/potentials/test_engine_goldfiles.py`` case for case. None of the
engines is installed, so both packages run on the same fake ``psi4``,
``openmm``, ``tblite`` and ``ase`` modules (taken from the JAX test file
itself, so they cannot drift apart) and parse the same golden xvg, g96 and
CPMD text. Each case runs once with each package's names, and the results
must be identical: energies, forces, what reached the fake engine, argv
and written files. Where a case goes through the device bridge the port's
gradient is also held against JAX's at 1e-9.
"""

import importlib.util
import json
import sys
import types
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfep_tpu.potentials as jax_potentials
import tfep_tpu.potentials.ase as jax_ase
import tfep_tpu.potentials.gromacs as jax_gromacs
import tfep_tpu.potentials.mimic as jax_mimic
import tfep_tpu.potentials.openmm as jax_openmm
import tfep_tpu.potentials.psi4 as jax_psi4
import tfep_tpu.potentials.tblite as jax_tblite
import tfep_tpu.units as jax_units
import tfep_tpu_torch.potentials as port_potentials
import tfep_tpu_torch.potentials.ase as port_ase
import tfep_tpu_torch.potentials.gromacs as port_gromacs
import tfep_tpu_torch.potentials.mimic as port_mimic
import tfep_tpu_torch.potentials.openmm as port_openmm
import tfep_tpu_torch.potentials.psi4 as port_psi4
import tfep_tpu_torch.potentials.tblite as port_tblite
import tfep_tpu_torch.units as port_units

from test_torch_common import GRAD_ATOL, close

ROOT = Path(__file__).resolve().parent


def _load(name, relative):
    """A JAX test module, loaded for its fakes and golden text."""
    spec = importlib.util.spec_from_file_location(name, ROOT / relative)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


MOCKS = _load('_jax_mock_engines', 'potentials/test_mock_engines.py')
GOLD = _load('_jax_engine_goldfiles', 'potentials/test_engine_goldfiles.py')


def _jax_grad(fn, x):
    return np.asarray(jax.grad(fn)(jnp.asarray(x)))


def _port_grad(fn, x):
    z = torch.tensor(np.asarray(x), requires_grad=True)
    fn(z).backward()
    return z.grad.numpy()


JAX = SimpleNamespace(
    potentials=jax_potentials, psi4=jax_psi4, openmm=jax_openmm,
    ase=jax_ase, tblite=jax_tblite, gromacs=jax_gromacs, mimic=jax_mimic,
    units=jax_units, array=jnp.asarray, value=np.asarray, grad=_jax_grad)
PORT = SimpleNamespace(
    potentials=port_potentials, psi4=port_psi4, openmm=port_openmm,
    ase=port_ase, tblite=port_tblite, gromacs=port_gromacs,
    mimic=port_mimic, units=port_units,
    array=lambda a: torch.tensor(np.asarray(a)),
    value=lambda a: a.detach().numpy(), grad=_port_grad)
BOTH = (JAX, PORT)


def _same(a, b):
    """Recursive equality of results (arrays bit for bit; NaN equals NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for key in a:
            _same(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (np.ndarray, np.generic, float)):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# =============================================================================
# Fake psi4
# =============================================================================

@pytest.fixture
def fake_psi4(monkeypatch):
    record = {}
    monkeypatch.setitem(sys.modules, 'psi4', MOCKS.make_fake_psi4(record))
    for m in BOTH:
        monkeypatch.setattr(m.psi4, 'PSI4_INSTALLED', True)
    return record


def psi4_energy_plumbing(m, record):
    record.clear()
    mol = MOCKS.FakeMolecule()
    positions = np.arange(6, dtype=float).reshape(2, 3)
    energy, forces = m.psi4._run_psi4_task(
        'mp2', mol, positions, False, 'orbitals.npy', 'restart.npy',
        'raise', {'basis': 'sto-3g'})
    assert record['activated'] is mol
    return (energy, forces, mol.geometry, mol.updated,
            dict(record['energy_call']))


def test_psi4_task_energy_plumbing(fake_psi4):
    ref = psi4_energy_plumbing(JAX, fake_psi4)
    out = psi4_energy_plumbing(PORT, fake_psi4)
    _same(out, ref)
    energy, forces, geometry, updated, call = out
    assert energy == -7.25 and forces is None and updated
    np.testing.assert_array_equal(geometry,
                                  np.arange(6, dtype=float).reshape(2, 3))
    assert call['name'] == 'mp2' and call['basis'] == 'sto-3g'
    assert call['write_orbitals'] == 'orbitals.npy'
    assert call['restart_file'] == 'restart.npy'


def psi4_forces_sign(m, record):
    record.clear()
    energy, forces = m.psi4._run_psi4_task(
        'scf', MOCKS.FakeMolecule(), np.zeros((2, 3)), True, False, None,
        'raise', {})
    return energy, forces, dict(record['gradient_call'])


def test_psi4_task_forces_sign(fake_psi4):
    ref = psi4_forces_sign(JAX, fake_psi4)
    energy, forces, call = psi4_forces_sign(PORT, fake_psi4)
    _same((energy, forces, call), ref)
    assert energy == -7.5
    np.testing.assert_allclose(forces, -0.5)
    # write_orbitals=False / restart_file=None are not forwarded.
    assert 'write_orbitals' not in call and 'restart_file' not in call


def psi4_unconverged(m):
    positions = np.zeros((2, 3))
    with pytest.raises(MOCKS.FakeSCFError):
        m.psi4._run_psi4_task('scf', MOCKS.FakeMolecule(), positions, False,
                              False, None, 'raise', {})
    return m.psi4._run_psi4_task('scf', MOCKS.FakeMolecule(), positions,
                                 True, False, None, 'nan', {})


def test_psi4_task_unconverged_policies(monkeypatch):
    monkeypatch.setitem(sys.modules, 'psi4',
                        MOCKS.make_fake_psi4({}, fail=True))
    ref = psi4_unconverged(JAX)
    energy, forces = psi4_unconverged(PORT)
    _same((energy, forces), ref)
    assert np.isnan(energy)
    np.testing.assert_array_equal(forces, np.zeros((2, 3)))


def psi4_restart_keys(m, path, monkeypatch):
    pot = m.psi4.Psi4Potential('scf', molecule=MOCKS.FakeMolecule(),
                               restart_dir=str(path))
    assert pot.uses_sample_keys
    calls = []

    def fake_run(func, args):
        calls.extend(args)
        return [(-1.0, None)] * len(args)

    monkeypatch.setattr(pot.parallelization_strategy, 'run', fake_run)
    energies = pot.compute_energies(np.zeros((2, 6)),
                                    sample_keys=np.array([7, 3]))
    first = [(task[4], task[5]) for task in calls]
    (path / 'sample-7.npy').write_bytes(b'')
    calls.clear()
    pot.compute_energies(np.zeros((2, 6)), sample_keys=np.array([7, 3]))
    second = [(task[4], task[5]) for task in calls]

    def strip(p):
        return None if p is None else p.replace(str(path), '<dir>')

    return (energies, [tuple(map(strip, t)) for t in first],
            [tuple(map(strip, t)) for t in second])


def test_psi4_restart_dir_keys(fake_psi4, tmp_path, monkeypatch):
    """restart_dir derives per-sample paths from trajectory sample keys and
    only passes restart_file once the file exists."""
    ref = psi4_restart_keys(JAX, tmp_path / 'jax', monkeypatch)
    energies, first, second = psi4_restart_keys(PORT, tmp_path / 'port',
                                                monkeypatch)
    _same((energies, first, second), ref)
    assert first == [('<dir>/sample-7.npy', None),
                     ('<dir>/sample-3.npy', None)]
    assert second == [('<dir>/sample-7.npy', '<dir>/sample-7.npy'),
                      ('<dir>/sample-3.npy', None)]


@pytest.mark.parametrize('m', BOTH, ids=['jax', 'port'])
def test_psi4_restart_dir_requires_keys(fake_psi4, tmp_path, m):
    pot = m.psi4.Psi4Potential('scf', molecule=MOCKS.FakeMolecule(),
                               restart_dir=str(tmp_path / 'wfn'))
    with pytest.raises(ValueError, match='sample_keys'):
        pot.compute_energies(np.zeros((1, 6)))


@pytest.mark.parametrize('m', BOTH, ids=['jax', 'port'])
def test_psi4_restart_dir_exclusive(fake_psi4, tmp_path, m):
    with pytest.raises(ValueError, match='mutually exclusive'):
        m.psi4.Psi4Potential('scf', restart_dir=str(tmp_path),
                             restart_file='x.npy')


def test_psi4_potential_through_the_bridge(fake_psi4):
    """The class end to end: hartree/bohr to kcal/mol and angstrom, the
    energy and the gradient ``-forces * g`` equal JAX's."""
    def run(m):
        ureg = m.units.ureg
        pot = m.psi4.Psi4Potential(
            'scf', molecule=MOCKS.FakeMolecule(),
            positions_unit=ureg.angstrom,
            energy_unit=ureg.kilocalorie_per_mole)
        x = np.arange(12, dtype=np.float64).reshape(2, 6)
        return m.value(pot(m.array(x))), m.grad(lambda z: pot(z).sum(), x)

    (ref_e, ref_g), (e, g) = run(JAX), run(PORT)
    _same(e, ref_e)
    close(g, ref_g, GRAD_ATOL)
    hartree = float(PORT.units.Quantity(1.0, PORT.units.ureg.hartree).to(
        PORT.units.ureg.kilocalorie_per_mole).magnitude)
    bohr = float(PORT.units.Quantity(1.0, PORT.units.ureg.bohr).to(
        PORT.units.ureg.angstrom).magnitude)
    # Without a gradient the energy-only call (psi4.energy: -7.25).
    np.testing.assert_allclose(e, -7.25 * hartree, rtol=1e-12)
    # The fake's gradient is 0.5 hartree/bohr everywhere.
    np.testing.assert_allclose(g, 0.5 * hartree / bohr, rtol=1e-12)


# =============================================================================
# Fake openmm
# =============================================================================

@pytest.fixture
def fake_openmm(monkeypatch):
    platforms = []
    monkeypatch.setitem(sys.modules, 'openmm',
                        MOCKS.make_fake_openmm(platforms))
    for m in BOTH:
        monkeypatch.setattr(m.openmm, 'global_context_cache',
                            m.openmm.ContextPool())
    return platforms


def openmm_plumbing(m, platforms):
    positions = np.arange(6, dtype=float).reshape(2, 3)
    box = np.diag([2.0, 2.0, 2.0])
    energy, forces = m.openmm._run_single_point_calculation(
        'fake-system', 'CPU', {'Threads': '2'}, 'sysA', True, positions, box)
    context = m.openmm.global_context_cache['sysA']
    platform = platforms[-1]
    return (energy, forces, platform.name, dict(platform.properties),
            context.positions, context.box_vectors)


def test_openmm_task_plumbing(fake_openmm):
    ref = openmm_plumbing(JAX, fake_openmm)
    out = openmm_plumbing(PORT, fake_openmm)
    _same(out, ref)
    energy, forces, name, properties, positions, box = out
    assert energy == -42.0 and name == 'CPU'
    assert properties == {'Threads': '2'}
    np.testing.assert_array_equal(forces, np.ones((2, 3)))
    np.testing.assert_array_equal(box, np.diag([2.0, 2.0, 2.0]))


@pytest.mark.parametrize('m', BOTH, ids=['jax', 'port'])
def test_openmm_context_cache_reuse(fake_openmm, m):
    positions = np.zeros((2, 3))
    m.openmm._run_single_point_calculation('sys', None, {}, 'named', False,
                                           positions, None)
    first = m.openmm.global_context_cache['named']
    # Second call with system=None must reuse the cached Context.
    m.openmm._run_single_point_calculation(None, None, {}, 'named', False,
                                           positions, None)
    assert m.openmm.global_context_cache['named'] is first
    with pytest.raises(KeyError):
        m.openmm._run_single_point_calculation(None, None, {}, 'missing',
                                               False, positions, None)


@pytest.mark.parametrize('m', BOTH, ids=['jax', 'port'])
def test_openmm_anonymous_context_not_cached(fake_openmm, m):
    m.openmm._run_single_point_calculation('sys', None, {}, None, False,
                                           np.zeros((1, 3)), None)
    assert None not in m.openmm.global_context_cache


# =============================================================================
# Fake ASE
# =============================================================================

def ase_plumbing(m):
    template = MOCKS.FakeAtoms()
    positions = np.arange(6, dtype=float)
    cell = np.diag([9.0, 9.0, 9.0])
    with_forces = m.ase._run_ase_task(template, positions, cell, True)
    assert template.positions is None and template.cell is None
    return with_forces, m.ase._run_ase_task(template, positions, None, False)


def test_ase_task_plumbing():
    ref = ase_plumbing(JAX)
    out = ase_plumbing(PORT)
    _same(out, ref)
    (energy, forces), (_, no_forces) = out
    positions = np.arange(6, dtype=float)
    assert energy == float(np.sum(positions ** 2))
    np.testing.assert_allclose(forces, -2.0 * positions)
    assert no_forces is None


# =============================================================================
# Fake tblite
# =============================================================================

@pytest.fixture
def fake_tblite(monkeypatch):
    record = {}
    package, interface = MOCKS.make_fake_tblite(record)
    monkeypatch.setitem(sys.modules, 'tblite', package)
    monkeypatch.setitem(sys.modules, 'tblite.interface', interface)
    return record


def tblite_plumbing(m, record):
    positions = np.arange(6, dtype=float).reshape(2, 3)
    energy, gradient = m.tblite._run_single_point(
        'GFN2-xTB', [8, 1], True, 0, False, positions)
    return energy, gradient, record['init'], dict(record['settings'])


def test_tblite_task_plumbing(fake_tblite):
    ref = tblite_plumbing(JAX, fake_tblite)
    out = tblite_plumbing(PORT, fake_tblite)
    _same(out, ref)
    energy, gradient, (method, numbers, init_positions), settings = out
    assert energy == -5.5 and method == 'GFN2-xTB' and numbers == [8, 1]
    np.testing.assert_allclose(gradient, 0.25)
    np.testing.assert_array_equal(init_positions,
                                  np.arange(6, dtype=float).reshape(2, 3))
    assert settings == {'verbosity': 0}


def tblite_failures(m):
    positions = np.zeros((2, 3))
    with pytest.raises(RuntimeError, match='SCC'):
        m.tblite._run_single_point('GFN2-xTB', [8, 1], False, 0, False,
                                   positions)
    return m.tblite._run_single_point('GFN2-xTB', [8, 1], True, 0, True,
                                      positions)


def test_tblite_task_failure_policies(monkeypatch):
    package, interface = MOCKS.make_fake_tblite({}, fail=True)
    monkeypatch.setitem(sys.modules, 'tblite', package)
    monkeypatch.setitem(sys.modules, 'tblite.interface', interface)
    ref = tblite_failures(JAX)
    energy, gradient = tblite_failures(PORT)
    _same((energy, gradient), ref)
    assert np.isnan(energy)
    np.testing.assert_array_equal(gradient, np.zeros((2, 3)))


# =============================================================================
# Functional APIs (reference's *_potential_energy forms)
# =============================================================================

def tblite_functional(m):
    positions = np.arange(12, dtype=np.float64).reshape(2, 6)
    fn = m.potentials.tblite_potential_energy
    energies = m.value(fn(m.array(positions), 'GFN2-xTB', [8, 1]))
    return energies, m.grad(lambda p: fn(p, 'GFN2-xTB', [8, 1]).sum(),
                            positions)


def test_tblite_potential_energy_functional(fake_tblite, monkeypatch):
    for m in BOTH:
        monkeypatch.setattr(m.tblite, 'TBLITE_INSTALLED', True)
    (ref_e, ref_g), (e, g) = tblite_functional(JAX), tblite_functional(PORT)
    _same(e, ref_e)
    close(g, ref_g, GRAD_ATOL)
    np.testing.assert_allclose(e, -5.5)
    # backward = -forces * g = +gradient (forces = -gradient = -0.25).
    np.testing.assert_allclose(g, 0.25)


@pytest.fixture
def fake_ase(monkeypatch):
    fake = types.ModuleType('ase')
    fake.Atoms = object
    monkeypatch.setitem(sys.modules, 'ase', fake)
    for m in BOTH:
        monkeypatch.setattr(m.ase, 'ASE_INSTALLED', True)


def ase_functional(m):
    template = MOCKS.FakeAtoms()
    positions = np.arange(6, dtype=np.float64).reshape(1, 6)
    fn = m.potentials.ase_potential_energy
    return (m.value(fn(m.array(positions), template)),
            m.grad(lambda p: fn(p, template).sum(), positions))


def test_ase_potential_energy_functional(fake_ase):
    (ref_e, ref_g), (e, g) = ase_functional(JAX), ase_functional(PORT)
    _same(e, ref_e)
    close(g, ref_g, GRAD_ATOL)
    np.testing.assert_allclose(e, [float(np.sum(np.arange(6.0) ** 2))])
    # d(sum x^2)/dx = 2x (engine forces are -2x; backward flips the sign).
    np.testing.assert_allclose(g, 2.0 * np.arange(6.0)[None], rtol=1e-12)


@pytest.mark.parametrize('m', BOTH, ids=['jax', 'port'])
def test_ase_template_atoms_exclusive(fake_ase, m):
    with pytest.raises(ValueError, match='not both'):
        m.ase.ASEPotential(atoms=MOCKS.FakeAtoms(), symbols='OH')
    with pytest.raises(ValueError, match='calculator is required'):
        m.ase.ASEPotential()


def test_openmm_potential_energy_functional(fake_openmm, monkeypatch):
    def run(m):
        monkeypatch.setattr(m.openmm, 'OPENMM_INSTALLED', True)
        positions = m.array(np.arange(6, dtype=np.float64).reshape(1, 6))
        return m.value(m.potentials.openmm_potential_energy(
            positions, system=object(), system_name='sys-func'))

    ref, energies = run(JAX), run(PORT)
    assert energies.shape == (1,)
    _same(energies, ref)


@pytest.mark.parametrize('m', BOTH, ids=['jax', 'port'])
def test_ase_template_not_mutated(fake_ase, m):
    """Attaching a calculator to a user-supplied template Atoms must not
    clobber the template's own calculator."""
    template = MOCKS.FakeAtoms()
    template.calc = 'users-own-calculator'
    pot = m.ase.ASEPotential(calculator='potentials-calculator',
                             atoms=template)
    assert template.calc == 'users-own-calculator'
    assert pot.atoms.calc == 'potentials-calculator'


# =============================================================================
# Golden files (tests/potentials/test_engine_goldfiles.py)
# =============================================================================

def _xvg(m, path, text):
    path.write_text(text)
    return np.atleast_2d(m.gromacs._read_xvg(str(path)))


def test_gmx_energy_xvg_gold(tmp_path):
    ref = _xvg(JAX, tmp_path / 'energy.xvg', GOLD.GMX_ENERGY_XVG)
    data = _xvg(PORT, tmp_path / 'energy.xvg', GOLD.GMX_ENERGY_XVG)
    np.testing.assert_array_equal(data, ref)
    assert data.shape == (1, 2)
    assert data[0, 0] == 0.0 and data[0, 1] == -59064.726562


def test_gmx_forces_xvg_gold(tmp_path):
    ref = _xvg(JAX, tmp_path / 'forces.xvg', GOLD.GMX_FORCES_XVG)
    data = _xvg(PORT, tmp_path / 'forces.xvg', GOLD.GMX_FORCES_XVG)
    np.testing.assert_array_equal(data, ref)
    assert data.shape == (1, 7)
    forces = data[0, 1:].reshape(-1, 3)
    np.testing.assert_allclose(
        forces[0], [112.5289154, -54.12874146, 3.876543021])
    np.testing.assert_allclose(forces.sum(axis=0), 0.0, atol=1e-9)


def test_cpmd_energies_gold(tmp_path):
    (tmp_path / 'ENERGIES').write_text(GOLD.CPMD_ENERGIES)
    energy = PORT.mimic._read_first_energy(str(tmp_path))
    assert energy == JAX.mimic._read_first_energy(str(tmp_path))
    # Column 4 (EKS, hartree) of the step-1 row.
    assert energy == -17.17466761


def test_cpmd_ftrajectory_gold(tmp_path):
    (tmp_path / 'FTRAJECTORY').write_text(GOLD.CPMD_FTRAJECTORY)
    forces = PORT.mimic._read_first_force(str(tmp_path), {})
    np.testing.assert_array_equal(
        forces, JAX.mimic._read_first_force(str(tmp_path), {}))
    assert forces.shape == (3, 3)
    np.testing.assert_allclose(
        forces[0], [0.00218870123, -0.00134921035, 0.00091220814])
    np.testing.assert_allclose(forces[2], [-0.001, 0.001, 0.001])


def test_cpmd_ftrajectory_gold_with_overlap_reorder(tmp_path):
    (tmp_path / 'FTRAJECTORY').write_text(GOLD.CPMD_FTRAJECTORY)
    overlaps = {0: 2, 2: 0}
    forces = PORT.mimic._read_first_force(str(tmp_path), overlaps)
    np.testing.assert_array_equal(
        forces, JAX.mimic._read_first_force(str(tmp_path), overlaps))
    np.testing.assert_allclose(forces[0], [-0.001, 0.001, 0.001])
    np.testing.assert_allclose(
        forces[2], [0.00218870123, -0.00134921035, 0.00091220814])


def test_g96_writer_gold(tmp_path):
    """The g96 both packages stage for grompp: the same bytes, which parse
    under an independent fixed-width GROMOS96 parser."""
    positions_nm = np.array([
        [0.123456789, -1.234567891, 2.345678912],
        [-0.000000001, 0.5, 25.0],
    ])
    box = np.diag([3.0, 4.0, 5.0])[None]
    texts = []
    for m in BOTH:
        path = tmp_path / m.gromacs.__name__
        path.mkdir()
        texts.append(open(m.gromacs._create_g96_file(
            str(path), positions_nm, box)).read())
    ref, text = texts
    assert text == ref
    lines = text.splitlines()
    assert lines[:4] == ['TITLE', lines[1], 'END', 'POSITIONRED']
    parsed = [[float(row[i * 15:(i + 1) * 15]) for i in range(3)]
              for row in lines[4:6]]
    assert all(len(row) == 45 for row in lines[4:6])
    np.testing.assert_allclose(parsed, positions_nm, atol=1e-9)
    assert lines[6:8] == ['END', 'BOX'] and lines[9] == 'END'
    box_fields = [float(lines[8][i * 15:(i + 1) * 15]) for i in range(9)]
    np.testing.assert_allclose(box_fields[:3], [3.0, 4.0, 5.0])
    np.testing.assert_allclose(box_fields[3:], 0.0)


# =============================================================================
# The two file-based wrappers end to end, on fake executables
# =============================================================================
# ``gmx`` and ``cpmd`` stand-ins (Python scripts put first on PATH) compute
# u = 0.5 |x|^2 and forces -x in the engines' own units from the files the
# wrappers stage (the .g96 frame, the rewritten CPMD deck) and write the
# outputs the wrappers parse (.edr/.trr read back through ``gmx energy``
# and ``gmx traj`` into xvg tables; CPMD's ENERGIES and FTRAJECTORY in the
# golden layouts above). Each call's argv, stdin and directory is logged,
# so both packages' wrappers are held to the same energies, forces,
# command lines and staged files.

FAKE_GMX = '''\
import json, os, sys
import numpy as np

argv = sys.argv[1:]
stdin = '' if argv[0] in ('grompp', 'mdrun') else sys.stdin.read()
with open(os.environ['FAKE_ENGINE_LOG'], 'a') as log:
    log.write(json.dumps(dict(exe='gmx', argv=argv, cwd=os.getcwd(),
                              stdin=stdin)) + '\\n')
opts, i = {}, 1
while i < len(argv):
    if i + 1 < len(argv) and not argv[i + 1].startswith('-'):
        opts[argv[i]] = argv[i + 1]
        i += 2
    else:
        opts[argv[i]] = True
        i += 1


def g96_positions(path):
    lines = open(path).read().splitlines()
    start = lines.index('POSITIONRED') + 1
    end = lines.index('END', start)
    return np.array([[float(r[j * 15:(j + 1) * 15]) for j in range(3)]
                     for r in lines[start:end]])


if argv[0] == 'grompp':
    with open(opts['-o'], 'w') as tpr:
        tpr.write(open(opts['-t']).read())
elif argv[0] == 'mdrun' and '-rerun' in opts:
    x = g96_positions(opts['-rerun'])
    json.dump({'energy': 0.5 * float(np.sum(x * x))}, open(opts['-e'], 'w'))
    json.dump({'forces': (-x).tolist()}, open(opts['-o'], 'w'))
elif argv[0] == 'energy':
    assert stdin.split() == ['Potential']
    energy = json.load(open(opts['-f']))['energy']
    with open(opts['-o'], 'w') as xvg:
        xvg.write('# gmx energy\\n@ s0 legend "Potential"\\n')
        xvg.write(f'    0.000000  {energy!r}\\n')
elif argv[0] == 'traj':
    assert stdin.split() == ['System'] and opts['-fp'] is True
    forces = np.asarray(json.load(open(opts['-f']))['forces']).reshape(-1)
    with open(opts['-of'], 'w') as xvg:
        xvg.write('# gmx traj\\n@TYPE xy\\n')
        xvg.write('\\t0\\t' + '\\t'.join(repr(float(f)) for f in forces)
                  + '\\n')
'''

FAKE_CPMD = '''\
import json, os, sys

with open(os.environ['FAKE_ENGINE_LOG'], 'a') as log:
    log.write(json.dumps(dict(exe='cpmd', argv=sys.argv[1:],
                              cwd=os.getcwd(), stdin='')) + '\\n')
lines = open(sys.argv[1]).read().splitlines()
start = lines.index('&ATOMS') + 1
rows, at = [], start
while lines[at].strip() != '&END':
    if lines[at].lstrip().startswith('*'):
        n = int(lines[at + 2])
        rows.extend(lines[at + 3:at + 3 + n])
        at += 3 + n
    else:
        at += 1
x = [[float(v) for v in row.split()] for row in rows]
energy = 0.5 * sum(v * v for atom in x for v in atom)
with open('ENERGIES', 'w') as f:
    f.write(f'       1  0.0  300.0  {energy!r}  0.0  0.0  0.0  1.0\\n')
with open('FTRAJECTORY', 'w') as f:
    f.write('  <<<<<<  NEW DATA  >>>>>>\\n')
    for atom in x:
        f.write('1 ' + ' '.join(repr(v) for v in atom) + ' 0 0 0 '
                + ' '.join(repr(-v) for v in atom) + '\\n')
print('CPMD: ENERGIES written')
'''

# Three QM atoms; GROMACS atoms 0, 1, 2 are CPMD atoms 2, 3, 1.
MIMIC_DECK = """\
&MIMIC
PATHS
1
/old/path
BOX
20.0 20.0 20.0
OVERLAPS
3
2 1 1 2
2 2 1 3
2 3 1 1
&END
&ATOMS
*O.pbe
 LMAX=P
   1
 0.0 0.0 0.0
*H.pbe
 LMAX=S
   2
 0.0 0.0 0.0
 0.0 0.0 0.0
&END
"""


@pytest.fixture
def fake_executables(tmp_path, monkeypatch):
    import os
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    for name, source in (('gmx', FAKE_GMX), ('cpmd', FAKE_CPMD)):
        path = bin_dir / name
        path.write_text(f'#!{sys.executable}\n' + source)
        path.chmod(0o755)
    log = tmp_path / 'engine.log'
    monkeypatch.setenv('PATH', f'{bin_dir}{os.pathsep}{os.environ["PATH"]}')
    monkeypatch.setenv('FAKE_ENGINE_LOG', str(log))
    return log


def _gromacs_potential(m, work):
    ureg = m.units.ureg
    return m.gromacs.GROMACSPotential(
        'topol.tpr', positions_unit=ureg.angstrom,
        energy_unit=ureg.kilocalorie_per_mole,
        working_dir_path=[str(work / f'sample{i}') for i in range(2)])


def _mimic_potential(m, work):
    import subprocess
    ureg = m.units.ureg
    (work / 'cpmd.in').write_text(MIMIC_DECK)
    return m.mimic.MiMiCPotential(
        m.mimic.Cpmd(str(work / 'cpmd.in'), 'pseudo/'),
        m.gromacs.GmxMdrun(omp_threads_per_rank=1),
        m.gromacs.GmxGrompp(mdp_path='mimic.mdp', topology_path='topol.top'),
        positions_unit=ureg.angstrom,
        energy_unit=ureg.kilocalorie_per_mole,
        working_dir_path=[str(work / f'sample{i}') for i in range(2)],
        launcher_kwargs={'stdout': subprocess.PIPE})


def file_engine_run(m, tmp_path, log, make_potential):
    work = tmp_path / m.units.__name__.split('.')[0]
    for i in range(2):
        (work / f'sample{i}').mkdir(parents=True)
    log.write_text('')
    pot = make_potential(m, work)
    x = np.random.default_rng(7).normal(size=(2, 9))
    energies, forces = pot.compute_energies_and_forces(x)
    value = m.value(pot(m.array(x)))
    grad = m.grad(lambda z: pot(z).sum(), x)
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    for call in calls:
        call['cwd'] = call['cwd'].replace(str(work), '<work>')
        call['argv'] = [a.replace(str(work), '<work>') for a in call['argv']]
    staged = {}
    for path in sorted(work.rglob('*')):
        if path.is_file():
            staged[str(path.relative_to(work))] = \
                path.read_text().replace(str(work), '<work>')
    return energies, forces, value, grad, calls, staged


@pytest.mark.parametrize('engine', ['gromacs', 'mimic'])
def test_file_engines_end_to_end(fake_executables, tmp_path, engine):
    make = {'gromacs': _gromacs_potential, 'mimic': _mimic_potential}[engine]
    ref = file_engine_run(JAX, tmp_path, fake_executables, make)
    out = file_engine_run(PORT, tmp_path, fake_executables, make)
    energies, forces, value, grad, calls, staged = out
    for a, b in zip(out[:4], ref[:4]):
        np.testing.assert_array_equal(a, b)
    assert calls == ref[4]
    assert staged == ref[5]

    # The values: u = 0.5 |x|^2 in the engine's units (GROMACS nm and
    # kJ/mol; CPMD bohr and hartree) from angstrom, in kcal/mol.
    ureg, Quantity = PORT.units.ureg, PORT.units.Quantity
    length, energy = {'gromacs': (ureg.nanometer, ureg.kilojoule_per_mole),
                      'mimic': (ureg.bohr, ureg.hartree)}[engine]
    to_engine = float(Quantity(1.0, ureg.angstrom).to(length).magnitude)
    from_engine = float(Quantity(1.0, energy).to(
        ureg.kilocalorie_per_mole).magnitude)
    x = np.random.default_rng(7).normal(size=(2, 9))
    u = 0.5 * np.sum((x * to_engine) ** 2, axis=-1) * from_engine
    # GROMACS stages the frame at 1e-9 nm (the g96 format).
    rtol = 1e-7 if engine == 'gromacs' else 1e-12
    np.testing.assert_allclose(energies, u, rtol=rtol)
    np.testing.assert_allclose(value, u, rtol=rtol)
    np.testing.assert_allclose(-forces, x * to_engine ** 2 * from_engine,
                               rtol=rtol, atol=1e-9)
    np.testing.assert_allclose(grad, -forces, rtol=1e-12)
    # 2 frames x 3 evaluations (the host call, the energy-only bridge call,
    # the bridge call with forces). GROMACS: mdrun and energy each time,
    # traj where forces are asked for; MiMiC: grompp, then cpmd (on the
    # staged deck) beside mdrun.
    runs = [(c['exe'], c['argv'][0]) for c in calls]
    if engine == 'gromacs':
        assert [runs.count(('gmx', sub)) for sub in
                ('mdrun', 'energy', 'traj')] == [6, 6, 4]
    else:
        assert runs.count(('gmx', 'grompp')) == 6
        assert runs.count(('gmx', 'mdrun')) == 6
        assert runs.count(('cpmd', 'cpmd.inp')) == 6
