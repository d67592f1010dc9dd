"""GROMACS potential: classical MM energies/forces via the ``gmx`` CLI.

A copy of ``tfep_tpu/potentials/gromacs.py``: the port keeps its own,
because importing the JAX package's module would import JAX.

File-based engine: each frame is written as a ``.g96`` coordinate file, a
``gmx mdrun -rerun`` single point runs in a per-sample working directory
(parallel-safe), the potential is extracted with ``gmx energy`` into an
``.xvg`` and forces with ``gmx traj -fp``. Engine units kJ/mol, nm.
Reference behaviors: upstream tfep/potentials/gromacs.py:44-785
(which reads the ``.edr`` through MDAnalysis — unavailable here, so the
energy is extracted via ``gmx energy`` instead).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

from tfep_tpu_torch.parallel.cli import CLITool, FlagOption, KeyValueOption
from tfep_tpu_torch.parallel.launcher import Launcher
from tfep_tpu_torch.potentials.engine import EnginePotential
from tfep_tpu_torch.utils.misc import clear_directory

__all__ = ['GROMACSPotential', 'gromacs_potential_energy',
           'GmxGrompp', 'GmxMdrun', 'GmxTraj',
           'GmxEnergy']

GMX_INSTALLED = shutil.which('gmx') is not None


class GmxGrompp(CLITool):
    """``gmx grompp`` preprocessor.

    Options render alphabetically by attribute name (the reference's
    ``inspect.getmembers`` ordering; see tests/parity):

    >>> GmxGrompp(mdp_path='sim.mdp', max_warnings=2).to_subprocess()
    ['gmx', 'grompp', '-maxwarn', '2', '-f', 'sim.mdp']
    """
    EXECUTABLE_PATH = 'gmx'
    SUBPROGRAM = 'grompp'
    mdp_path = KeyValueOption('-f')
    structure_path = KeyValueOption('-c')
    topology_path = KeyValueOption('-p')
    start_traj_path = KeyValueOption('-t')
    index_path = KeyValueOption('-n')
    tpr_path = KeyValueOption('-o')
    max_warnings = KeyValueOption('-maxwarn')


class GmxMdrun(CLITool):
    """``gmx mdrun`` (used with ``-rerun`` for single points)."""
    EXECUTABLE_PATH = 'gmx'
    SUBPROGRAM = 'mdrun'
    tpr_path = KeyValueOption('-s')
    rerun_path = KeyValueOption('-rerun')
    traj_path = KeyValueOption('-o')
    edr_path = KeyValueOption('-e')
    output_prefix = KeyValueOption('-deffnm')
    pme_ranks = KeyValueOption('-npme')
    thread_mpi_ranks = KeyValueOption('-ntmpi')
    omp_threads_per_rank = KeyValueOption('-ntomp')


class GmxTraj(CLITool):
    """``gmx traj`` (force extraction to .xvg)."""
    EXECUTABLE_PATH = 'gmx'
    SUBPROGRAM = 'traj'
    traj_path = KeyValueOption('-f')
    tpr_path = KeyValueOption('-s')
    forces_xvg_path = KeyValueOption('-of')
    high_precision = FlagOption('-fp', prepend_to_false='no')


class GmxEnergy(CLITool):
    """``gmx energy`` (energy extraction from .edr to .xvg)."""
    EXECUTABLE_PATH = 'gmx'
    SUBPROGRAM = 'energy'
    edr_path = KeyValueOption('-f')
    xvg_path = KeyValueOption('-o')


class GROMACSPotential(EnginePotential):
    """Differentiable potential energy via ``gmx mdrun -rerun``.

    File-based MM backend (reference:
    upstream tfep/potentials/gromacs.py:210-339): each batch sample
    is written as a ``.g96`` frame, rerun through ``gmx mdrun``, and its
    energy/forces read back from the ``.edr``/``.xvg`` outputs. Native
    units kJ/mol / nanometer.

    Parameters
    ----------
    tpr_file_path : str
        Portable run file carrying topology + simulation parameters
        (its coordinates are overwritten per frame by the rerun).
    launcher : Launcher, optional
        How the gmx subprocesses are launched (e.g.
        :class:`~tfep_tpu_torch.parallel.SRunLauncher` on SLURM).
    positions_unit, energy_unit : Unit, optional
        User-facing units (defaults nanometer / kJ/mol).
    precompute_gradient : bool, optional
        Extract forces in the same rerun as the energy.
    working_dir_path : str or list of str, optional
        Scratch directory; a per-sample list keeps parallel frames from
        colliding on output files.
    cleanup_working_dir : bool, optional
        Delete the scratch directories after each evaluation.
    parallelization_strategy : ParallelizationStrategy, optional
        Per-sample fan-out (thread pools suit subprocess engines).
    launcher_kwargs, mdrun_kwargs : dict, optional
        Extra options for the launcher / the ``gmx mdrun`` command.
    on_mdrun_error : {'raise', 'nan'}, optional
        Failure policy for crashed reruns.
    """

    DEFAULT_ENERGY_UNIT = 'kilojoule_per_mole'
    DEFAULT_POSITIONS_UNIT = 'nanometer'
    ENGINE_ENERGY_UNIT = 'kilojoule_per_mole'
    ENGINE_POSITIONS_UNIT = 'nanometer'

    def __init__(self, tpr_file_path: str, launcher: Optional[Launcher] = None,
                 positions_unit=None, energy_unit=None,
                 precompute_gradient: bool = True,
                 working_dir_path=None, cleanup_working_dir: bool = False,
                 parallelization_strategy=None,
                 launcher_kwargs: Optional[dict] = None,
                 mdrun_kwargs: Optional[dict] = None,
                 on_mdrun_error: str = 'raise'):
        """``tpr_file_path`` holds topology + simulation parameters (its
        coordinates are overwritten per frame). ``working_dir_path`` may be a
        list with one directory per batch sample."""
        super().__init__(positions_unit=positions_unit,
                         energy_unit=energy_unit,
                         parallelization_strategy=parallelization_strategy,
                         precompute_gradient=precompute_gradient)
        if on_mdrun_error not in ('raise', 'nan'):
            raise ValueError("on_mdrun_error must be 'raise' or 'nan'.")
        self.tpr_file_path = tpr_file_path
        self.launcher = launcher
        self.working_dir_path = working_dir_path
        self.cleanup_working_dir = cleanup_working_dir
        self.launcher_kwargs = launcher_kwargs
        self.mdrun_kwargs = mdrun_kwargs
        self.on_mdrun_error = on_mdrun_error

    def _compute_batch(self, positions: np.ndarray,
                       cell: Optional[np.ndarray], compute_forces: bool):
        task_args = []
        for i in range(positions.shape[0]):
            box_vectors = None
            if cell is not None:
                box_vectors = _cell_to_box_vectors(cell[i])
            task_args.append((
                self.tpr_file_path, compute_forces,
                self.cleanup_working_dir, self.launcher_kwargs,
                self.mdrun_kwargs, self.on_mdrun_error,
                positions[i].reshape(-1, 3), box_vectors, self.launcher,
                self._sample_working_dir(i)))
        results = self.parallelization_strategy.run(_run_gromacs_task,
                                                    task_args)
        energies = np.asarray([r[0] for r in results])
        forces = (np.stack([r[1].reshape(-1) for r in results])
                  if compute_forces else None)
        return energies, forces


# =============================================================================
# Engine-independent file I/O (tested without gmx)
# =============================================================================

def _cell_to_box_vectors(cell: np.ndarray) -> np.ndarray:
    """(6,) lengths+angles or (3,) lengths or (3,3) matrix -> (3,3) vectors."""
    cell = np.asarray(cell, dtype=np.float64)
    if cell.shape == (3, 3):
        return cell
    if cell.shape == (3,):
        return np.diag(cell)
    if cell.shape == (6,):
        a, b, c = cell[:3]
        alpha, beta, gamma = np.radians(cell[3:])
        v1 = np.array([a, 0.0, 0.0])
        v2 = np.array([b * np.cos(gamma), b * np.sin(gamma), 0.0])
        cx = c * np.cos(beta)
        cy = c * (np.cos(alpha) - np.cos(beta) * np.cos(gamma)) / np.sin(gamma)
        cz = np.sqrt(max(c ** 2 - cx ** 2 - cy ** 2, 0.0))
        v3 = np.array([cx, cy, cz])
        return np.stack([v1, v2, v3])
    raise ValueError(f'Unsupported cell shape {cell.shape}.')


def _create_g96_file(dir_path: str, positions_nm: np.ndarray,
                     box_vectors_nm: Optional[np.ndarray]) -> str:
    """Write ``configuration.g96`` (POSITIONRED + optional BOX section)."""
    g96_file_path = os.path.realpath(
        os.path.join(dir_path, 'configuration.g96'))
    with open(g96_file_path, 'w') as f:
        f.write('TITLE\ntfep\nEND\nPOSITIONRED\n')
        np.savetxt(f, positions_nm, fmt='%15.9f', delimiter='')
        f.write('END\n')
        if box_vectors_nm is not None:
            f.write('BOX\n')
            # g96 order: v1x v2y v3z v1y v1z v2x v2z v3x v3y.
            flat = box_vectors_nm.reshape(-1, 9)[
                :, [0, 4, 8, 1, 2, 3, 5, 6, 7]]
            np.savetxt(f, flat, fmt='%15.9f', delimiter='')
            f.write('END\n')
    return g96_file_path


def _read_xvg(xvg_file_path: str) -> np.ndarray:
    """Parse an .xvg data table, skipping comments/commands."""
    return np.loadtxt(xvg_file_path, comments=['#', '@'])


def _read_energy(edr_path: str, working_dir_path: str) -> float:
    """Extract the potential energy from an .edr via ``gmx energy``."""
    xvg_file_path = os.path.join(working_dir_path, 'energy.xvg')
    gmx_energy = GmxEnergy(edr_path=edr_path,
                           xvg_path=xvg_file_path)
    with subprocess.Popen(['echo', 'Potential'],
                          stdout=subprocess.PIPE) as p1:
        with subprocess.Popen(gmx_energy.to_subprocess(), stdin=p1.stdout,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL) as p2:
            p2.communicate()
    data = np.atleast_2d(_read_xvg(xvg_file_path))
    return float(data[0, 1])


def _read_forces(traj_path: str, tpr_file_path: str,
                 working_dir_path: str) -> np.ndarray:
    """Extract full-precision forces via ``gmx traj`` into an .xvg."""
    xvg_file_path = os.path.join(working_dir_path, 'forces.xvg')
    gmx_traj = GmxTraj(traj_path=traj_path,
                       tpr_path=tpr_file_path,
                       forces_xvg_path=xvg_file_path,
                       high_precision=True)
    with subprocess.Popen(['echo', 'System'], stdout=subprocess.PIPE) as p1:
        with subprocess.Popen(gmx_traj.to_subprocess(), stdin=p1.stdout) as p2:
            p2.communicate()
    # First xvg column is the time.
    return np.atleast_2d(_read_xvg(xvg_file_path))[0, 1:].reshape(-1, 3)


def _rerun_single_point(scratch_dir, tpr_file_path, positions_nm,
                        box_vectors_nm, launcher, launcher_kwargs,
                        mdrun_kwargs):
    """Stage the frame in ``scratch_dir`` and rerun it through mdrun.

    Returns ``(returncode, edr_path, trr_path)``; the caller decides how
    to react to a failed run and which outputs to read back.
    """
    frame_path = _create_g96_file(scratch_dir, positions_nm, box_vectors_nm)
    outputs = {'edr': os.path.join(scratch_dir, 'energy.edr'),
               'trr': os.path.join(scratch_dir, 'traj.trr')}
    mdrun = GmxMdrun(tpr_path=tpr_file_path,
                     rerun_path=frame_path,
                     traj_path=outputs['trr'],
                     edr_path=outputs['edr'],
                     **(mdrun_kwargs or {}))
    completed = (launcher or Launcher()).run(
        mdrun, cwd=scratch_dir, **(launcher_kwargs or {}))
    return completed.returncode, outputs['edr'], outputs['trr']


def _run_gromacs_task(tpr_file_path, return_forces, cleanup_working_dir,
                      launcher_kwargs, mdrun_kwargs, on_mdrun_error,
                      positions_nm, box_vectors_nm, launcher,
                      working_dir_path):
    """One ``gmx mdrun -rerun`` single point (nm in, kJ/mol out).

    Without a ``working_dir_path`` the frame runs in a throwaway temp
    directory; otherwise the given directory is used (and optionally
    emptied afterwards).
    """
    with contextlib.ExitStack() as scratch_stack:
        if working_dir_path is None:
            scratch_dir = scratch_stack.enter_context(
                tempfile.TemporaryDirectory())
        else:
            scratch_dir = working_dir_path
            if cleanup_working_dir:
                scratch_stack.callback(clear_directory, scratch_dir)
        scratch_dir = os.path.realpath(scratch_dir)

        returncode, edr_path, trr_path = _rerun_single_point(
            scratch_dir, tpr_file_path, positions_nm, box_vectors_nm,
            launcher, launcher_kwargs, mdrun_kwargs)

        if returncode == 0:
            energy = _read_energy(edr_path, scratch_dir)
            forces = (_read_forces(trr_path, tpr_file_path, scratch_dir)
                      if return_forces else None)
        elif on_mdrun_error == 'raise':
            raise RuntimeError('Single-point energy with mdrun returned '
                               'non-zero exit code.')
        else:
            energy = np.nan
            forces = np.zeros_like(positions_nm) if return_forces else None

    return energy, forces


def gromacs_potential_energy(batch_positions, tpr_file_path, batch_cell=None,
                             launcher=None, positions_unit=None,
                             energy_unit=None, precompute_gradient=True,
                             working_dir_path=None,
                             cleanup_working_dir=False,
                             parallelization_strategy=None,
                             launcher_kwargs=None, mdrun_kwargs=None,
                             on_mdrun_error='raise'):
    """Functional form of :class:`GROMACSPotential`.

    Returns differentiable per-sample energies via ``gmx mdrun -rerun``.
    Prefer the class for repeated evaluation. Reference:
    upstream tfep/potentials/gromacs.py.
    """
    potential = GROMACSPotential(
        tpr_file_path, launcher=launcher, positions_unit=positions_unit,
        energy_unit=energy_unit, precompute_gradient=precompute_gradient,
        working_dir_path=working_dir_path,
        cleanup_working_dir=cleanup_working_dir,
        parallelization_strategy=parallelization_strategy,
        launcher_kwargs=launcher_kwargs, mdrun_kwargs=mdrun_kwargs,
        on_mdrun_error=on_mdrun_error)
    return potential(batch_positions, batch_cell)
