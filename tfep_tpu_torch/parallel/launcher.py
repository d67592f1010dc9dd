"""Concurrent subprocess execution, locally or through SLURM ``srun``.

A copy of ``tfep_tpu/parallel/launcher.py``: the port keeps its own,
because importing the JAX package's module would import JAX.

This is the process-launch layer under the file-based engine backends:
GROMACS reruns, and the coupled CPMD+GROMACS MPMD pair used by MiMiC.
Capability parity with the reference's launcher layer
(upstream tfep/utils/cli/launcher.py), rebuilt around a job-group
abstraction: :class:`Launcher.run` spawns one :class:`_Job` per command,
lets them all run concurrently, then drains the group against a shared
wall-clock deadline. ``SRunLauncher`` plans SLURM command lines (including
``--multi-prog`` MPMD plans) before delegating to the same job group.

Example
-------
>>> launcher = Launcher()
>>> result = launcher.run(['echo', 'print this'], capture_output=True,
...                       text=True)
>>> result.stdout.strip()
'print this'
"""

from __future__ import annotations

import subprocess
import time
from typing import List, Optional, Union

from tfep_tpu_torch.parallel.cli import CLITool, KeyValueOption
from tfep_tpu_torch.utils.misc import temporary_cd

__all__ = ['Launcher', 'SRunTool', 'SRunLauncher']


def _as_argv(command):
    """Accept either an argv list or a CLITool and return an argv list."""
    if isinstance(command, CLITool):
        return command.to_subprocess()
    return command


def _per_command(value, n_commands: int, what: str = 'option') -> list:
    """Broadcast a scalar (or validate a per-command list) to length n."""
    if not isinstance(value, list):
        return [value] * n_commands
    if len(value) != n_commands:
        raise ValueError(
            f'Per-command {what} has {len(value)} entries for '
            f'{n_commands} commands: {value!r}')
    return list(value)


class _Job:
    """A single spawned subprocess within a concurrently-running group."""

    def __init__(self, argv, *, stdin, stdout, stderr, cwd, popen_kwargs):
        self.argv = argv
        self.process = subprocess.Popen(
            argv, stdin=stdin, stdout=stdout, stderr=stderr, cwd=cwd,
            **popen_kwargs)

    def drain(self, deadline: Optional[float]) -> subprocess.CompletedProcess:
        """Wait for completion (bounded by ``deadline``), collect output.

        On timeout the process is killed and ``subprocess.TimeoutExpired``
        is re-raised carrying whatever output was produced — the same
        contract as ``subprocess.run``.
        """
        remaining = None
        if deadline is not None:
            remaining = max(0.0, deadline - time.monotonic())
        try:
            out, err = self.process.communicate(timeout=remaining)
        except subprocess.TimeoutExpired as timeout_error:
            self.cancel()
            out, err = self.process.communicate()
            timeout_error.stdout, timeout_error.stderr = out, err
            raise
        except BaseException:
            self.cancel()
            self.process.wait()
            raise
        return subprocess.CompletedProcess(
            self.process.args, self.process.returncode, out, err)

    def cancel(self):
        self.process.kill()


class Launcher:
    """Run one or more commands as concurrently-executing subprocesses.

    Semantics mirror ``subprocess.run`` generalized to a command group:
    ``timeout`` bounds the whole group on one shared deadline, ``check``
    raises ``CalledProcessError`` for the first nonzero exit (after the
    whole group has been drained, so no job is left running), and
    ``stdin``/``stdout``/``stderr``/``cwd`` accept either one value for
    all commands or a per-command list.
    """

    def run(self, *commands, capture_output: bool = False,
            timeout: Optional[float] = None, check: bool = False,
            stdin=None, stdout=None, stderr=None, cwd=None, **popen_kwargs):
        """Start every command, wait for all, return their results.

        Returns a single ``subprocess.CompletedProcess`` when called with
        one command, else a list of them in command order.
        """
        n = len(commands)
        if capture_output:
            stdout = stderr = subprocess.PIPE
        streams = {
            'stdin': _per_command(stdin, n, 'stdin'),
            'stdout': _per_command(stdout, n, 'stdout'),
            'stderr': _per_command(stderr, n, 'stderr'),
            'cwd': _per_command(cwd, n, 'cwd'),
        }

        deadline = None
        if timeout is not None:
            deadline = time.monotonic() + timeout

        jobs: List[_Job] = []
        try:
            for idx, command in enumerate(commands):
                jobs.append(_Job(
                    _as_argv(command),
                    stdin=streams['stdin'][idx],
                    stdout=streams['stdout'][idx],
                    stderr=streams['stderr'][idx],
                    cwd=streams['cwd'][idx],
                    popen_kwargs=popen_kwargs))
            results = [job.drain(deadline) for job in jobs]
        except BaseException:
            # A spawn failure or a timeout/interrupt in one job must not
            # leak the rest of the group.
            for job in jobs:
                if job.process.poll() is None:
                    job.cancel()
                    job.process.wait()
            raise

        if check:
            for result in results:
                if result.returncode:
                    raise subprocess.CalledProcessError(
                        result.returncode, result.args,
                        output=result.stdout, stderr=result.stderr)

        return results[0] if n == 1 else results


class SRunTool(CLITool):
    """Declarative wrapper over SLURM's ``srun``."""

    EXECUTABLE_PATH = 'srun'
    time = KeyValueOption('--time')
    n_nodes = KeyValueOption('--nodes')
    n_tasks = KeyValueOption('--ntasks')
    n_tasks_per_node = KeyValueOption('--ntasks-per-node')
    n_cpus_per_task = KeyValueOption('--cpus-per-task')
    relative_node_idx = KeyValueOption('--relative')
    cpu_bind = KeyValueOption('--cpu-bind')
    distribution = KeyValueOption('--distribution')
    multiprog_config_file_path = KeyValueOption('--multi-prog')

    def to_subprocess(self):
        # srun rejects options placed after --multi-prog, so rotate that
        # pair to the end of the option block.
        argv = super().to_subprocess()
        if self.multiprog_config_file_path is not None:
            at = argv.index('--multi-prog')
            pair, rest = argv[at:at + 2], argv[at + 2:]
            argv = argv[:at] + rest + pair
        return argv


class SRunLauncher(Launcher):
    """Launch commands on a SLURM allocation via ``srun``.

    Two planning modes:

    * **standard** — every command gets its own ``srun`` prefix; every
      srun option (including ``n_tasks``) may be a per-command list;
    * **MPMD** (``multiprog=True``, with >1 command) — a single ``srun
      --multi-prog`` hosts all commands, with ``n_tasks`` (necessarily a
      list) defining each command's contiguous task-rank block in a
      generated plan file. This is how MiMiC's CPMD+GROMACS pair shares
      one allocation.

    ``GLOBAL_SRUN_OPTIONS`` is a class-level dict of fallback srun options
    applied wherever the constructor didn't set one (handy to configure
    site defaults once per process).
    """

    GLOBAL_SRUN_OPTIONS: dict = {}

    def __init__(self, n_tasks: Optional[Union[int, List[int]]] = None,
                 multiprog: bool = False,
                 multiprog_config_file_path: str = 'srun-job.conf',
                 **srun_options):
        super().__init__()
        self.n_tasks = n_tasks
        self.multiprog = multiprog
        self.multiprog_config_file_path = multiprog_config_file_path
        self.srun_kwargs = srun_options

    # ------------------------------------------------------------------ #
    def run(self, *commands, **kwargs):
        self._check_plan(len(commands))
        argvs = self._plan_srun_argvs(commands)
        if self._plans_multiprog(len(commands)):
            # srun resolves the plan-file path against the job's working
            # directory, which the caller may redirect with cwd.
            job_cwd = kwargs.get('cwd', None)
            with temporary_cd(job_cwd):
                self._write_multiprog_plan(commands)
        return super().run(*argvs, **kwargs)

    # ------------------------------------------------------------------ #
    def _plans_multiprog(self, n_commands: int) -> bool:
        return self.multiprog and n_commands > 1

    def _check_plan(self, n_commands: int):
        """Validate constructor options against the command count."""
        named = dict(self.srun_kwargs, n_tasks=self.n_tasks)
        if self._plans_multiprog(n_commands):
            if not isinstance(self.n_tasks, list):
                raise ValueError(
                    'With multiprog execution, "n_tasks" must be a list.')
            bad = [k for k, v in self.srun_kwargs.items()
                   if isinstance(v, list)]
            if bad:
                raise ValueError(
                    f'With multiprog execution, "{bad[0]}" cannot be a list.')
        for name, value in named.items():
            if isinstance(value, list) and len(value) != n_commands:
                raise ValueError(
                    f'Passed {n_commands} commands but {len(value)} '
                    f'{name}: {value}')

    def _srun_option_plan(self, n_commands: int) -> List[dict]:
        """Per-command srun option dicts (constructor > global defaults)."""
        declared = dict(self.srun_kwargs, n_tasks=self.n_tasks)
        columns = {name: _per_command(value, n_commands, name)
                   for name, value in declared.items()}
        plans = []
        for idx in range(n_commands):
            plan = dict(self.GLOBAL_SRUN_OPTIONS)
            for name, values in columns.items():
                if values[idx] is not None:
                    plan[name] = values[idx]
            plans.append(plan)
        return plans

    def _plan_srun_argvs(self, commands) -> List[list]:
        """Plan the final argv list(s): one per command, or one MPMD srun."""
        argvs = [_as_argv(c) for c in commands]
        if self._plans_multiprog(len(argvs)):
            # One srun owning the union of all task ranks; per-command
            # options are meaningless here (enforced by _check_plan) and
            # n_tasks_per_node would fight the explicit rank plan.
            plan = dict(self.GLOBAL_SRUN_OPTIONS)
            plan.update((k, v) for k, v in self.srun_kwargs.items()
                        if k != 'n_tasks_per_node' and v is not None)
            plan['n_tasks'] = sum(self.n_tasks)
            plan['multiprog_config_file_path'] = \
                self.multiprog_config_file_path
            return [SRunTool(**plan).to_subprocess()]
        plans = self._srun_option_plan(len(argvs))
        return [SRunTool(**plan).to_subprocess() + argv
                for plan, argv in zip(plans, argvs)]

    def _write_multiprog_plan(self, commands):
        """Write the ``--multi-prog`` plan file (rank-range per command)."""
        lines = []
        next_rank = 0
        for n_tasks, command in zip(self.n_tasks, commands):
            block = (str(next_rank) if n_tasks == 1
                     else f'{next_rank}-{next_rank + n_tasks - 1}')
            lines.append(' '.join([block, *_as_argv(command)]))
            next_rank += n_tasks
        with open(self.multiprog_config_file_path, 'w') as plan_file:
            plan_file.write('\n'.join(lines) + '\n')
