"""The port's runtime and PLUMED utilities against the JAX package's.

Mirrors ``tests/parallel/test_runtime.py`` (strategies, CLI tools and
launchers, in the echo-substitution style of the reference) and
``tests/utils/test_plumed.py`` (COLVAR tables, dataset aux data,
``sum_hills``) case for case. Each case runs with the names of one
package and of the other, and the results must be identical. The
process-pool case takes its pool from a ``spawn`` context, as a machine
with a CUDA card must, and runs a task of the port's own modules in it.
"""

import doctest
import multiprocessing
import os
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest

import tfep_tpu.io.topology as jax_topology
import tfep_tpu.io.traj as jax_traj
import tfep_tpu.parallel as jax_parallel
import tfep_tpu.utils.plumed as jax_plumed
import tfep_tpu_torch.io.topology as port_topology
import tfep_tpu_torch.io.traj as port_traj
import tfep_tpu_torch.parallel as port_parallel
import tfep_tpu_torch.parallel.cli
import tfep_tpu_torch.parallel.launcher
import tfep_tpu_torch.potentials.gromacs
import tfep_tpu_torch.potentials.mimic
import tfep_tpu_torch.utils.plumed as port_plumed

from torch_pool_tasks import ase_task_and_modules

JAX = SimpleNamespace(parallel=jax_parallel, plumed=jax_plumed,
                      topology=jax_topology, traj=jax_traj)
PORT = SimpleNamespace(parallel=port_parallel, plumed=port_plumed,
                       topology=port_topology, traj=port_traj)
BOTH = pytest.mark.parametrize('m', [JAX, PORT], ids=['jax', 'port'])


def _add(x, y):
    return x + y


def _both(case, *args, **kwargs):
    ref, port = case(JAX, *args, **kwargs), case(PORT, *args, **kwargs)
    assert port == ref
    return port


# =============================================================================
# Strategies
# =============================================================================

ARGS = [(1, 2), (3, 4), (5, 6)]


class TestStrategies:
    def test_serial(self):
        assert _both(lambda m: m.parallel.SerialStrategy().run(_add, ARGS)) \
            == [3, 7, 11]

    def test_thread_pool(self):
        def case(m):
            s = m.parallel.ThreadPoolStrategy(max_workers=2)
            try:
                return s.run(_add, ARGS)
            finally:
                s.shutdown()

        assert _both(case) == [3, 7, 11]

    def test_process_pool(self):
        with multiprocessing.get_context('spawn').Pool(2) as pool:
            def case(m):
                return m.parallel.ProcessPoolStrategy(pool).run(_add, ARGS)

            assert _both(case) == [3, 7, 11]

    def test_spawn_pool_runs_the_ports_task_functions(self):
        """A spawned worker imports the port's engine module (no CUDA, no
        JAX at import) and unpickles its module-level task function; the
        results are bit-identical to the serial strategy's."""
        args = [(np.arange(6.0),), (2 * np.arange(6.0),)]
        serial = port_parallel.SerialStrategy().run(ase_task_and_modules,
                                                    args)
        with multiprocessing.get_context('spawn').Pool(2) as pool:
            pooled = port_parallel.ProcessPoolStrategy(pool).run(
                ase_task_and_modules, args)
        for (e_ref, f_ref, _), (e, f, modules) in zip(serial, pooled):
            assert e == e_ref
            np.testing.assert_array_equal(f, f_ref)
            assert 'tfep_tpu_torch.potentials.ase' in modules
            assert not any(name == 'jax' or name.startswith('tfep_tpu.')
                           for name in modules)


# =============================================================================
# CLI tools
# =============================================================================

def grep_tool(m):
    class MyGrep(m.parallel.CLITool):
        EXECUTABLE_PATH = 'grep'
        patterns_file_path = m.parallel.KeyValueOption('-f')
        max_count = m.parallel.KeyValueOption('-m')
        print_version = m.parallel.FlagOption('-v')
        absolute = m.parallel.AbsolutePathOption('-p')
        toggled = m.parallel.FlagOption('-t', prepend_to_false='no')

    return MyGrep


def argv(m, *args, **kwargs):
    return grep_tool(m)(*args, **kwargs).to_subprocess()


class TestCLITool:
    def test_flag(self):
        assert _both(argv, print_version=True) == ['grep', '-v']
        assert _both(argv, print_version=False) == ['grep']
        assert _both(argv) == ['grep']

    def test_key_value_and_args(self):
        out = _both(argv, 'input.txt', patterns_file_path='pat.txt',
                    max_count=3)
        assert out[0] == 'grep' and out[-1] == 'input.txt'
        assert ('-m' in out) and ('3' in out) and ('-f' in out)

    def test_absolute_path(self):
        out = _both(argv, absolute='rel/path.txt')
        assert os.path.isabs(out[out.index('-p') + 1])

    def test_no_prefix_flag(self):
        assert _both(argv, toggled=False) == ['grep', '-not']
        assert _both(argv, toggled=True) == ['grep', '-t']

    @BOTH
    def test_undefined_option(self, m):
        with pytest.raises(AttributeError, match='Undefined'):
            grep_tool(m)(bogus=2)

    @BOTH
    def test_flag_rejects_non_bool(self, m):
        with pytest.raises(ValueError, match='boolean or None'):
            grep_tool(m)(print_version='yes')

    def test_executable_path_override(self):
        out = _both(argv, executable_path='/usr/bin/grep')
        assert out[0] == '/usr/bin/grep'

    def test_subprogram(self):
        def case(m):
            class Sub(m.parallel.CLITool):
                EXECUTABLE_PATH = 'tool'
                SUBPROGRAM = 'sub'
            return Sub('x').to_subprocess()

        assert _both(case) == ['tool', 'sub', 'x']


# =============================================================================
# Launchers
# =============================================================================

def echo(m, text):
    class Echo(m.parallel.CLITool):
        EXECUTABLE_PATH = 'echo'
    return Echo(text)


class TestLauncher:
    def test_single_command(self):
        def case(m):
            result = m.parallel.Launcher().run(
                ['echo', 'hello'], capture_output=True, text=True)
            return result.stdout, result.returncode

        assert _both(case) == ('hello\n', 0)

    def test_clitool_command(self):
        def case(m):
            return m.parallel.Launcher().run(
                echo(m, 'print this'), capture_output=True, text=True).stdout

        assert _both(case).strip() == 'print this'

    def test_parallel_commands(self):
        def case(m):
            results = m.parallel.Launcher().run(
                echo(m, 'a'), echo(m, 'b'), capture_output=True, text=True)
            return [r.stdout.strip() for r in results]

        assert _both(case) == ['a', 'b']

    @BOTH
    def test_check_raises(self, m):
        with pytest.raises(subprocess.CalledProcessError):
            m.parallel.Launcher().run(['false'], check=True)

    def test_per_command_cwd(self, tmp_path):
        (tmp_path / 'a').mkdir()
        (tmp_path / 'b').mkdir()

        def case(m):
            results = m.parallel.Launcher().run(
                ['pwd'], ['pwd'], capture_output=True, text=True,
                cwd=[str(tmp_path / 'a'), str(tmp_path / 'b')])
            return [r.stdout.strip() for r in results]

        out = _both(case)
        assert out[0].endswith('/a') and out[1].endswith('/b')

    @BOTH
    def test_per_command_list_length_checked(self, m):
        with pytest.raises(ValueError, match='2 entries for 1 commands'):
            m.parallel.Launcher().run(['true'], cwd=['.', '.'])

    @BOTH
    def test_timeout(self, m):
        with pytest.raises(subprocess.TimeoutExpired):
            m.parallel.Launcher().run(['sleep', '5'], timeout=0.2)


class TestSRunLauncher:
    def test_standard_commands(self):
        def case(m):
            return m.parallel.SRunLauncher(n_tasks=4, n_nodes=2) \
                ._plan_srun_argvs([['prog', 'arg']])

        assert _both(case) == [['srun', '--nodes', '2', '--ntasks', '4',
                                'prog', 'arg']]

    def test_per_command_options(self):
        def case(m):
            return m.parallel.SRunLauncher(n_tasks=[2, 3], n_nodes=[1, 4]) \
                ._plan_srun_argvs([['a'], ['b']])

        cmds = _both(case)
        assert cmds[0] == ['srun', '--nodes', '1', '--ntasks', '2', 'a']
        assert cmds[1] == ['srun', '--nodes', '4', '--ntasks', '3', 'b']

    def test_global_options(self, monkeypatch):
        def case(m):
            monkeypatch.setattr(m.parallel.SRunLauncher,
                                'GLOBAL_SRUN_OPTIONS', {'time': '1:00'})
            return m.parallel.SRunLauncher(n_tasks=2)._plan_srun_argvs(
                [['a']])

        assert _both(case) == [['srun', '--ntasks', '2', '--time', '1:00',
                                'a']]

    def test_multiprog_command_and_config(self, tmp_path):
        commands = [['a'], ['b', 'x'], ['c']]

        def case(m):
            config = tmp_path / f'{m.parallel.__name__}.conf'
            launcher = m.parallel.SRunLauncher(
                n_tasks=[2, 3, 2], multiprog=True,
                multiprog_config_file_path=str(config), n_nodes=4)
            cmds = launcher._plan_srun_argvs(commands)
            launcher._write_multiprog_plan(commands)
            cmds[0][-1] = os.path.basename(cmds[0][-1]).split('.', 2)[-1]
            return cmds, config.read_text()

        cmds, text = _both(case)
        # One srun for all commands; --multi-prog last.
        assert len(cmds) == 1 and cmds[0][-2:] == ['--multi-prog', 'conf']
        assert cmds[0][cmds[0].index('--ntasks') + 1] == '7'
        assert text.splitlines() == ['0-1 a', '2-4 b x', '5-6 c']

    @BOTH
    def test_multiprog_requires_list(self, m):
        launcher = m.parallel.SRunLauncher(n_tasks=3, multiprog=True)
        with pytest.raises(ValueError, match='must be a list'):
            launcher.run(['a'], ['b'])


# =============================================================================
# PLUMED (tests/utils/test_plumed.py)
# =============================================================================

COLVAR = """\
#! FIELDS time cv1 bias
 0.0 1.10 0.5
 1.0 1.20 0.7
 1.0 1.20 0.7
 2.0 1.15 0.9
"""


@pytest.fixture
def colvar_file(tmp_path):
    path = tmp_path / 'COLVAR'
    path.write_text(COLVAR)
    return str(path)


def _tables_equal(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    else:
        np.testing.assert_array_equal(a, b)


def test_read_field_names(colvar_file):
    assert _both(lambda m: m.plumed.read_table_field_names(colvar_file)) \
        == ['time', 'cv1', 'bias']


def test_read_n_rows(colvar_file):
    assert _both(lambda m: m.plumed.read_table_n_rows(colvar_file)) == 4


@pytest.mark.parametrize('kwargs', [
    {}, {'remove_duplicates': False}, {'col_names': ['bias'],
                                       'as_array': True},
    {'ordering_col_name': 'cv1', 'col_names': ['cv1', 'bias']},
    {'row_filter_func': lambda line: not line.startswith(' 0.0')},
], ids=['all', 'duplicates', 'array', 'ordered', 'filtered'])
def test_read_table(colvar_file, kwargs):
    data = port_plumed.read_table(colvar_file, **kwargs)
    _tables_equal(data, jax_plumed.read_table(colvar_file, **kwargs))
    if not kwargs:
        np.testing.assert_allclose(data['time'], [0.0, 1.0, 2.0])
        np.testing.assert_allclose(data['bias'], [0.5, 0.7, 0.9])
    if kwargs.get('as_array'):
        np.testing.assert_allclose(data[:, 0], [0.5, 0.7, 0.9])


def test_write_read_roundtrip(tmp_path):
    data = {'time': np.arange(3.0), 'x': np.asarray([0.1, 0.2, 0.3])}
    texts = []
    for m in (JAX, PORT):
        path = str(tmp_path / f'{m.plumed.__name__}.dat')
        m.plumed.write_table(data, path)
        back = m.plumed.read_table(path)
        np.testing.assert_allclose(back['x'], data['x'])
        assert m.plumed.read_table_field_names(path) == ['time', 'x']
        texts.append(open(path).read())
    assert texts[1] == texts[0]


def aux_dataset(m, colvar_file, **kwargs):
    system = m.traj.System(m.topology.Topology(names=['C']),
                           np.zeros((3, 1, 3)))
    dataset = m.traj.TrajectoryDataset(system)
    m.plumed.add_plumed_aux_to_dataset(dataset, colvar_file, **kwargs)
    return dataset[1], dataset.get_batch([0, 2])


def test_add_aux_to_dataset(colvar_file):
    ref_sample, ref_batch = aux_dataset(JAX, colvar_file,
                                        col_names=['time', 'bias'])
    sample, batch = aux_dataset(PORT, colvar_file,
                                col_names=['time', 'bias'])
    assert sample['bias'] == ref_sample['bias'] == 0.7
    assert sorted(batch) == sorted(ref_batch)
    for key in batch:
        np.testing.assert_array_equal(batch[key], ref_batch[key])
    np.testing.assert_allclose(batch['bias'], [0.5, 0.9])


def test_add_aux_with_unit_conversion(colvar_file):
    def case(m):
        from importlib import import_module
        ureg = import_module(m.traj.__name__.split('.')[0] + '.units').ureg
        return aux_dataset(m, colvar_file, col_names=['time', 'bias'],
                           units={'bias': ureg.kilojoule_per_mole},
                           dest_units={'bias': ureg.kilocalorie_per_mole})

    (ref_sample, ref_batch), (sample, batch) = case(JAX), case(PORT)
    assert sample['bias'] == ref_sample['bias']
    np.testing.assert_array_equal(batch['bias'], ref_batch['bias'])
    np.testing.assert_allclose(batch['bias'], np.array([0.5, 0.9]) / 4.184)


def test_sum_hills_command():
    def case(m):
        return m.plumed.PlumedSumHills(
            hills_file_path='HILLS', out_file_path='fes.dat').to_subprocess()

    out = _both(case)
    assert out[:2] == ['plumed', 'sum_hills']
    assert '--hills' in out and '--outfile' in out


def test_check_plumed_is_installed():
    assert port_plumed.check_plumed_is_installed() == \
        jax_plumed.check_plumed_is_installed()


# =============================================================================
# Doctests of the port's copies (tests/test_doctests.py runs the JAX ones)
# =============================================================================

@pytest.mark.parametrize('module', [
    tfep_tpu_torch.parallel.cli,
    tfep_tpu_torch.parallel.launcher,
    tfep_tpu_torch.potentials.gromacs,
    tfep_tpu_torch.potentials.mimic,
], ids=lambda m: m.__name__)
def test_module_doctests(module):
    results = doctest.testmod(module, verbose=False,
                              optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.failed == 0 and results.attempted > 0
