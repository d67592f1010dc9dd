"""The port's potentials layer against the JAX package's, case for case.

Mirrors ``tests/potentials/test_potentials.py``. Each case runs once with
the names of ``tfep_tpu`` and once with those of ``tfep_tpu_torch`` on the
same seeded numpy inputs (float64 on the CPU), and the two results must
agree at 1e-10 for values and 1e-9 for gradients, besides the analytic
values the JAX test holds: the autograd bridge's values and gradient
(``-forces * g``), the cell and the sample keys, which host call each
evaluation makes (energy and forces with a gradient, energy only
without), the unit conversion, a NaN energy reaching
``boltzmann_kl_div_loss(ignore_nan=True)``, the forces' finite-difference
vector-Hessian product, and the GROMACS and CPMD file handling (written
files compared byte for byte).
"""

import textwrap
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfep_tpu.loss as jax_loss
import tfep_tpu.potentials as jax_potentials
import tfep_tpu.potentials.gromacs as jax_gromacs
import tfep_tpu.potentials.mimic as jax_mimic
import tfep_tpu.units as jax_units
import tfep_tpu_torch.loss as port_loss
import tfep_tpu_torch.potentials as port_potentials
import tfep_tpu_torch.potentials.gromacs as port_gromacs
import tfep_tpu_torch.potentials.mimic as port_mimic
import tfep_tpu_torch.units as port_units
from tfep_tpu_torch.potentials.bridge import make_callback_forces

from test_torch_common import ATOL, GRAD_ATOL, close

BATCH, N_DOFS = 4, 6


def _jax_grad(fn, x, *args):
    return np.asarray(jax.grad(fn)(jnp.asarray(x), *args))


def _port_grad(fn, x, *args):
    z = torch.tensor(np.asarray(x), requires_grad=True)
    fn(z, *args).backward()
    return z.grad.numpy()


def _names(potentials, gromacs, mimic, units, loss, array, grad, value):
    return SimpleNamespace(
        make_callback_potential=potentials.make_callback_potential,
        EnginePotential=potentials.EnginePotential,
        gromacs=gromacs, mimic=mimic, ureg=units.ureg,
        boltzmann_kl_div_loss=loss.boltzmann_kl_div_loss,
        array=array, grad=grad, value=value)


JAX = _names(jax_potentials, jax_gromacs, jax_mimic, jax_units, jax_loss,
             jnp.asarray, _jax_grad, lambda a: np.asarray(a))
PORT = _names(port_potentials, port_gromacs, port_mimic, port_units,
              port_loss, lambda a: torch.tensor(np.asarray(a)), _port_grad,
              lambda a: a.detach().numpy())


def _both(case, *args):
    """``case`` with each package's names; returns (jax, port)."""
    return case(JAX, *args), case(PORT, *args)


def _positions(seed=0, shape=(BATCH, N_DOFS)):
    return np.random.default_rng(seed).normal(size=shape)


# =============================================================================
# Callback bridge
# =============================================================================

class _Host:
    """Host energy and forces of 0.5 |x|^2, counting calls by kind."""

    def __init__(self):
        self.calls = []

    def energy_and_forces(self, x, *aux):
        self.calls.append('energy_and_forces')
        x = np.asarray(x)
        return 0.5 * np.sum(x ** 2, axis=-1), -x

    def energy(self, x, *aux):
        self.calls.append('energy')
        return 0.5 * np.sum(np.asarray(x) ** 2, axis=-1)


def bridge_forward(m):
    pot = m.make_callback_potential(_Host().energy_and_forces)
    return m.value(pot(m.array(_positions())))


def bridge_gradient(m):
    pot = m.make_callback_potential(_Host().energy_and_forces)
    return m.grad(lambda z: pot(z).sum(), _positions())


def bridge_mean_loss(m):
    pot = m.make_callback_potential(_Host().energy_and_forces)
    if m is JAX:
        loss = jax.jit(lambda z: jnp.mean(pot(z)))
    else:
        loss = lambda z: pot(z).mean()  # noqa: E731
    x = _positions()
    return float(loss(m.array(x))), m.grad(loss, x)


def bridge_with_cell(m):
    def host(x, cell):
        return (np.sum(np.asarray(x), axis=-1)
                + np.sum(np.asarray(cell), axis=-1),
                np.ones_like(np.asarray(x)))

    pot = m.make_callback_potential(host, has_cell=True)
    x = np.ones((BATCH, N_DOFS))
    cell = m.array(2.0 * np.ones((BATCH, 3)))
    return m.value(pot(m.array(x), cell)), m.grad(
        lambda z, c: pot(z, c).sum(), x, cell)


class TestCallbackBridge:
    def test_forward_values(self):
        ref, port = _both(bridge_forward)
        close(port, ref)
        close(port, 0.5 * np.sum(_positions() ** 2, axis=-1))

    def test_gradient_is_minus_forces(self):
        ref, port = _both(bridge_gradient)
        close(port, ref, GRAD_ATOL)
        # d(0.5 x^2)/dx = x = -forces.
        close(port, _positions(), GRAD_ATOL)

    def test_under_jit(self):
        (ref_val, ref_grad), (val, grad) = _both(bridge_mean_loss)
        assert np.isfinite(val)
        close(val, ref_val)
        close(grad, ref_grad, GRAD_ATOL)
        close(grad, _positions() / BATCH, GRAD_ATOL)

    def test_with_cell(self):
        (ref_e, ref_g), (e, g) = _both(bridge_with_cell)
        close(e, ref_e)
        close(e, np.full(BATCH, N_DOFS + 6.0))
        close(g, ref_g, GRAD_ATOL)
        close(g, -np.ones((BATCH, N_DOFS)), GRAD_ATOL)

    def test_host_calls_by_kind(self):
        """A gradient makes one energy-and-forces call; an evaluation
        without one (no grad mode, or positions that need none) makes
        only energy calls, as the JAX primal does."""
        host = _Host()
        pot = PORT.make_callback_potential(host.energy_and_forces,
                                           energy_fn=host.energy)
        x = torch.tensor(_positions(), requires_grad=True)
        pot(x).sum().backward()
        with torch.no_grad():
            pot(x)
        pot(x.detach())
        assert host.calls == ['energy_and_forces', 'energy', 'energy']

        jax_host = _Host()
        jax_pot = JAX.make_callback_potential(jax_host.energy_and_forces,
                                              energy_fn=jax_host.energy)
        jax.grad(lambda z: jnp.sum(jax_pot(z)))(jnp.asarray(_positions()))
        jax_pot(jnp.asarray(_positions()))
        assert jax_host.calls == ['energy_and_forces', 'energy']

    def test_gradient_equals_autograd_of_torch_potential(self):
        """Through a loss, ``-forces * g`` equals autograd through the
        same potential written in torch."""
        pot = PORT.make_callback_potential(_Host().energy_and_forces)
        weights = torch.tensor(np.random.default_rng(1).normal(size=BATCH))
        x = _positions()
        bridged = _port_grad(lambda z: (weights * torch.exp(-pot(z) / 10))
                             .sum(), x)
        direct = _port_grad(lambda z: (weights * torch.exp(
            -0.5 * (z * z).sum(-1) / 10)).sum(), x)
        close(bridged, direct, GRAD_ATOL)

    def test_result_on_device_and_dtype_of_positions(self):
        pot = PORT.make_callback_potential(_Host().energy_and_forces)
        x = torch.tensor(_positions(), dtype=torch.float32)
        e = pot(x)
        assert e.dtype == torch.float32 and e.device == x.device
        assert e.shape == (BATCH,)

    def test_aux_count_checked(self):
        pot = PORT.make_callback_potential(_Host().energy_and_forces,
                                           n_aux=1)
        with pytest.raises(TypeError, match='1 auxiliary'):
            pot(torch.zeros(BATCH, N_DOFS))


# =============================================================================
# EnginePotential unit conversion + NaN policy
# =============================================================================

def harmonic_engine(m):
    """The fake engine of the JAX test on ``m``'s EnginePotential:
    U = 0.5 k |x|^2 with k = 1 eV/A^2, in eV/angstrom."""

    class HarmonicEngine(m.EnginePotential):
        DEFAULT_ENERGY_UNIT = 'eV'
        DEFAULT_POSITIONS_UNIT = 'angstrom'
        ENGINE_ENERGY_UNIT = 'eV'
        ENGINE_POSITIONS_UNIT = 'angstrom'

        fail_samples: set = set()

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.seen = []

        def _compute_batch(self, positions, cell, compute_forces):
            self.seen.append((compute_forces, self._current_sample_keys))
            energies = 0.5 * np.sum(positions ** 2, axis=-1)
            for i in self.fail_samples:
                energies[i] = np.nan
            forces = -positions if compute_forces else None
            return energies, forces

    return HarmonicEngine


def engine_native_units(m):
    pot = harmonic_engine(m)()
    return m.value(pot(m.array(_positions())))


def engine_unit_conversion(m):
    pot = harmonic_engine(m)(positions_unit=m.ureg.nanometer,
                             energy_unit=m.ureg.kilocalorie_per_mole)
    x_nm = np.full((1, 3), 0.1)          # = 1 angstrom per DOF
    return (m.value(pot(m.array(x_nm))),
            m.grad(lambda z: pot(z).sum(), x_nm))


def engine_sample_keys(m):
    class KeyedEngine(harmonic_engine(m)):
        uses_sample_keys = True

    pot = KeyedEngine()
    keys = m.array(np.array([5, 2, 9, 0]))
    if m is JAX:
        fn = jax.jit(lambda z, k: jnp.sum(pot(z, sample_keys=k)))
    else:
        fn = lambda z, k: pot(z, sample_keys=k).sum()  # noqa: E731
    grad = m.grad(fn, np.ones((BATCH, N_DOFS)), keys)
    return grad, pot.seen


def engine_nan_policy(m):
    pot = harmonic_engine(m)()
    pot.fail_samples = {1}
    e = pot(m.array(np.ones((3, N_DOFS))))
    loss = m.boltzmann_kl_div_loss(e, ignore_nan=True)
    return m.value(e), float(loss)


class TestEnginePotential:
    def test_native_units(self):
        ref, port = _both(engine_native_units)
        close(port, ref)
        close(port, 0.5 * np.sum(_positions() ** 2, axis=-1))

    def test_unit_conversion(self):
        """Positions in nm, energies in kcal/mol: both conversions apply."""
        (ref_e, ref_g), (e, g) = _both(engine_unit_conversion)
        close(e, ref_e)
        close(g, ref_g, GRAD_ATOL)
        # Engine: 0.5 * 3 * (1 A)^2 = 1.5 eV -> kcal/mol.
        np.testing.assert_allclose(e[0], 1.5 * 23.060547830619026,
                                   rtol=1e-6)
        # Gradient chain rule: dE[kcal/mol]/dx[nm].
        np.testing.assert_allclose(g[0], 23.060547830619026 * 10.0,
                                   rtol=1e-6)

    def test_sample_keys_ride_the_callback(self):
        """Per-sample keys passed to __call__ reach _compute_batch with the
        positions; the gradient makes one call with forces."""
        (ref_g, ref_seen), (g, seen) = _both(engine_sample_keys)
        close(g, ref_g, GRAD_ATOL)
        assert np.all(np.isfinite(g))
        assert [f for f, _ in seen] == [True]
        for _, keys in ref_seen + seen:
            np.testing.assert_array_equal(keys, [5, 2, 9, 0])

    def test_sample_keys_from_a_host_tensor(self):
        """The port's batches keep ``trajectory_sample_index`` on the host
        as a tensor; it reaches the engine as int64 numpy."""
        class KeyedEngine(harmonic_engine(PORT)):
            uses_sample_keys = True

        pot = KeyedEngine()
        pot(torch.ones(2, N_DOFS), sample_keys=torch.tensor([3, 1]))
        keys = pot.seen[0][1]
        assert keys.dtype == np.int64
        np.testing.assert_array_equal(keys, [3, 1])

    def test_no_grad_evaluation_is_energy_only(self):
        pot = harmonic_engine(PORT)()
        with torch.no_grad():
            pot(torch.ones(2, N_DOFS, requires_grad=True))
        x = torch.ones(2, N_DOFS, requires_grad=True)
        pot(x).sum().backward()
        assert [f for f, _ in pot.seen] == [False, True]

    def test_caller_dtype_restored(self):
        pot = harmonic_engine(PORT)()
        energies, forces = pot.compute_energies_and_forces(
            np.ones((2, N_DOFS), np.float32))
        assert energies.dtype == forces.dtype == np.float32
        assert pot.compute_energies(
            np.ones((2, N_DOFS), np.float32)).dtype == np.float32

    def test_nan_policy_flows_to_loss(self):
        (ref_e, ref_loss), (e, loss) = _both(engine_nan_policy)
        assert np.isnan(e[1]) and np.isnan(ref_e[1])
        assert np.isfinite(loss)
        close(loss, ref_loss)
        np.testing.assert_array_equal(np.isnan(e), np.isnan(ref_e))


# =============================================================================
# GROMACS file I/O (no gmx needed)
# =============================================================================

def g96_text(m, path):
    positions = np.arange(9, dtype=float).reshape(3, 3) / 10
    box = np.diag([4.0, 3.0, 2.0])
    path.mkdir()
    return open(m.gromacs._create_g96_file(str(path), positions, box)).read()


def xvg_values(m, path):
    xvg = path / 'f.xvg'
    xvg.write_text('# comment\n@ legend\n0.0 1.0 2.0 3.0\n')
    return m.gromacs._read_xvg(str(xvg))


class TestGromacsIO:
    def test_g96_file(self, tmp_path):
        ref = g96_text(JAX, tmp_path / 'jax')
        content = g96_text(PORT, tmp_path / 'port')
        assert content == ref
        assert 'POSITIONRED' in content and 'BOX' in content
        box_line = content.split('BOX\n')[1].splitlines()[0].split()
        assert [float(x) for x in box_line[:3]] == [4.0, 3.0, 2.0]

    @pytest.mark.parametrize('cell', [[2.0, 3.0, 4.0],
                                      [2.0, 3, 4, 90, 90, 90],
                                      [2.0, 3, 4, 80, 95, 70]])
    def test_cell_to_box_vectors(self, cell):
        ref = JAX.gromacs._cell_to_box_vectors(np.asarray(cell))
        box = PORT.gromacs._cell_to_box_vectors(np.asarray(cell))
        np.testing.assert_array_equal(box, ref)
        if len(cell) == 3 or cell[3:] == [90, 90, 90]:
            np.testing.assert_allclose(box, np.diag(cell[:3]), atol=1e-12)

    def test_read_xvg(self, tmp_path):
        (tmp_path / 'jax').mkdir()
        (tmp_path / 'port').mkdir()
        ref = xvg_values(JAX, tmp_path / 'jax')
        values = xvg_values(PORT, tmp_path / 'port')
        np.testing.assert_array_equal(values, ref)
        np.testing.assert_allclose(values, [0.0, 1.0, 2.0, 3.0])

    def test_grompp_command(self):
        # Options render alphabetically by attribute name (the reference's
        # inspect.getmembers ordering).
        argv = PORT.gromacs.GmxGrompp(mdp_path='sim.mdp',
                                      max_warnings=2).to_subprocess()
        assert argv == JAX.gromacs.GmxGrompp(
            mdp_path='sim.mdp', max_warnings=2).to_subprocess()
        assert argv[:2] == ['gmx', 'grompp']
        assert sorted([tuple(argv[i:i + 2]) for i in range(2, len(argv), 2)]) \
            == [('-f', 'sim.mdp'), ('-maxwarn', '2')]

    def test_mdrun_command(self):
        argv = PORT.gromacs.GmxMdrun(output_prefix='sim',
                                     omp_threads_per_rank=4).to_subprocess()
        assert argv == JAX.gromacs.GmxMdrun(
            output_prefix='sim', omp_threads_per_rank=4).to_subprocess()
        assert argv[:2] == ['gmx', 'mdrun']
        assert sorted([tuple(argv[i:i + 2]) for i in range(2, len(argv), 2)]) \
            == [('-deffnm', 'sim'), ('-ntomp', '4')]


# =============================================================================
# MiMiC / CPMD input handling (no engines needed)
# =============================================================================

CPMD_INPUT = textwrap.dedent("""\
    &MIMIC
    PATHS
    1
    /old/path
    BOX
    20.0 20.0 20.0
    OVERLAPS
    2
    2 1 1 1
    2 3 1 2
    &END
    &ATOMS
    *O.pbe
     LMAX=P
       1
     1.0 2.0 3.0
    *H.pbe
     LMAX=S
       1
     4.0 5.0 6.0
    &END
    """)


def cpmd_prepare(m, path):
    path.mkdir()
    (path / 'cpmd.in').write_text(CPMD_INPUT)
    cmd = m.mimic.Cpmd(str(path / 'cpmd.in'))
    positions = np.arange(9, dtype=float).reshape(3, 3)
    new_cmd, overlaps = m.mimic._prepare_cpmd_command(
        cmd, str(path), positions, np.asarray([30.0, 30.0, 30.0]))
    text = (path / 'cpmd.inp').read_text()
    return new_cmd.to_subprocess(), overlaps, text.replace(str(path), '<dir>')


def cpmd_outputs(m, path):
    path.mkdir()
    (path / 'ENERGIES').write_text(
        '1  0.0  0.0  -17.1234  0.0\n2  0.0  0.0  -17.2  0.0\n')
    # FTRAJECTORY: step, 3 pos, 3 vel, 3 force.
    (path / 'FTRAJECTORY').write_text(
        '1 0 0 0 0 0 0 0.1 0.2 0.3\n'
        '1 0 0 0 0 0 0 0.4 0.5 0.6\n'
        '2 0 0 0 0 0 0 9.0 9.0 9.0\n')
    return (m.mimic._read_first_energy(str(path)),
            m.mimic._read_first_force(str(path), {0: 1, 1: 0}))


class TestCpmdInput:
    def test_cpmd_command(self):
        argv = PORT.mimic.Cpmd('input.in', 'pseudo/').to_subprocess()
        assert argv == JAX.mimic.Cpmd('input.in', 'pseudo/').to_subprocess()
        assert argv == ['cpmd', 'input.in', 'pseudo/']

    def test_parse(self, tmp_path):
        path = tmp_path / 'cpmd.in'
        path.write_text(CPMD_INPUT)
        parsed = PORT.mimic._parse_cpmd_input(str(path))
        assert parsed == JAX.mimic._parse_cpmd_input(str(path))
        lines, paths_idx, box_idx, overlaps, atom_lines = parsed
        assert lines[paths_idx].strip() == '/old/path'
        assert lines[box_idx].split() == ['20.0', '20.0', '20.0']
        # OVERLAPS: gromacs 1-based 1->cpmd 1, gromacs 3->cpmd 2.
        assert overlaps == {0: 0, 2: 1}
        assert lines[atom_lines[0]].split() == ['1.0', '2.0', '3.0']
        assert lines[atom_lines[1]].split() == ['4.0', '5.0', '6.0']

    def test_prepare_rewrites(self, tmp_path):
        ref = cpmd_prepare(JAX, tmp_path / 'jax')
        argv, overlaps, text = cpmd_prepare(PORT, tmp_path / 'port')
        assert (argv, overlaps, text) == ref
        assert argv[1] == 'cpmd.inp'
        rewritten = text.splitlines()
        assert '<dir>' in text
        assert any(line.split() == ['30.0', '30.0', '30.0']
                   for line in rewritten)
        assert any(line.split() == ['0.0', '1.0', '2.0'] for line in rewritten)
        assert any(line.split() == ['6.0', '7.0', '8.0'] for line in rewritten)

    def test_read_energy_and_force(self, tmp_path):
        ref_energy, ref_force = cpmd_outputs(JAX, tmp_path / 'jax')
        energy, force = cpmd_outputs(PORT, tmp_path / 'port')
        assert energy == ref_energy == -17.1234
        np.testing.assert_array_equal(force, ref_force)
        np.testing.assert_allclose(force, [[0.4, 0.5, 0.6], [0.1, 0.2, 0.3]])


# =============================================================================
# Engine-gated tests (skipped when the engines are absent, as in the JAX
# file; engine behaviour on fakes is in tests/test_torch_engines.py).
# =============================================================================

def test_ase_potential_lj():
    from tfep_tpu_torch.potentials.ase import ASE_INSTALLED
    if not ASE_INSTALLED:
        pytest.skip('ase is not importable')
    from ase.calculators.lj import LennardJones
    from tfep_tpu_torch.potentials import ASEPotential

    x = torch.tensor([[0.0, 0, 0, 3.4, 0, 0]], requires_grad=True)
    e = ASEPotential(calculator=LennardJones(), symbols='Ar2')(x)
    assert np.isfinite(float(e[0]))
    e.sum().backward()
    assert torch.all(torch.isfinite(x.grad))


def test_tblite_potential_water():
    from tfep_tpu_torch.potentials.tblite import TBLITE_INSTALLED
    if not TBLITE_INSTALLED:
        pytest.skip('tblite is not importable')
    from tfep_tpu_torch.potentials import TBLitePotential

    pot = TBLitePotential('GFN2-xTB', numbers=[8, 1, 1])
    e = pot(torch.tensor([[0.0, 0, 0, 0, 1.8, 0, 1.7, -0.5, 0]]))
    assert float(e[0]) < 0


# =============================================================================
# Force matching: forces() and its finite-difference backward.
# =============================================================================

def force_matching(m):
    pot = harmonic_engine(m)()
    x = _positions(3, (2, N_DOFS))
    f = m.value(pot.forces(m.array(x)))
    f_target = np.zeros_like(x)

    def loss(z):
        return 0.5 * ((pot.forces(z) - m.array(f_target)) ** 2).sum()

    return f, m.grad(loss, x)


class _CubicHost:
    """Forces of u = sum(x^4)/4 + x0 x1 (per row): the Hessian varies with
    x, so the finite difference is not exact and both packages must take
    the same one."""

    def __call__(self, x, *aux):
        x = np.asarray(x)
        forces = -x ** 3
        forces[:, 0] -= x[:, 1]
        forces[:, 1] -= x[:, 0]
        return np.zeros(len(x)), forces


def fd_product(m, with_zero_row):
    x = _positions(4, (3, N_DOFS))
    g = _positions(5, (3, N_DOFS))
    if with_zero_row:
        g[1] = 0.0
    if m is JAX:
        forces = jax_potentials.bridge.make_callback_forces(_CubicHost())
        _, vjp = jax.vjp(forces, jnp.asarray(x))
        return np.asarray(vjp(jnp.asarray(g))[0])
    forces = make_callback_forces(_CubicHost())
    z = torch.tensor(x, requires_grad=True)
    forces(z).backward(torch.tensor(g))
    return z.grad.numpy()


class TestForceMatching:
    def test_forces_values_and_hessian(self):
        """forces() is differentiable: grad gives FD vector-Hessian
        products."""
        (ref_f, ref_g), (f, g) = _both(force_matching)
        x = _positions(3, (2, N_DOFS))
        close(f, ref_f)
        close(f, -x)
        close(g, ref_g, ATOL)
        # Analytic: dL/dx = (F - F_t)^T dF/dx = (-x)^T (-I) = x.
        np.testing.assert_allclose(g, x, rtol=1e-5, atol=1e-7)

    @pytest.mark.parametrize('with_zero_row', [False, True])
    def test_fd_product_equals_jax(self, with_zero_row):
        ref, port = _both(fd_product, with_zero_row)
        close(port, ref, ATOL)
        if with_zero_row:
            np.testing.assert_array_equal(port[1], 0.0)
