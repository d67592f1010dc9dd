"""MiMiC potential: QM/MM with CPMD + GROMACS running concurrently (MPMD).

A copy of ``tfep_tpu/potentials/mimic.py``: the port keeps its own,
because importing the JAX package's module would import JAX.

Each single point launches CPMD and ``gmx mdrun`` together (one
``launcher.run(cpmd_cmd, mdrun_cmd)`` call — on SLURM typically an
``SRunLauncher`` with ``multiprog=True``). Per sample, the CPMD input is
rewritten (&MIMIC PATHS working directory, &MIMIC BOX, QM atom coordinates
in the &ATOMS block via the &MIMIC OVERLAPS index map) and the ``.tpr`` is
regenerated through grompp from a ``.g96`` written with the new positions.
Energies come from the CPMD ``ENERGIES`` file and forces from
``FTRAJECTORY`` (reordered CPMD->GROMACS). Failure handling: ``n_attempts``
retries on crash-without-error-file, ``LocalError-*.log`` detection, and
``DENSITY NOT CONVERGED`` stdout parsing with
``on_unconverged='raise'|'nan'|'success'`` and ``on_local_error`` policies.
Engine units hartree/bohr. Capability parity with the reference backend
(upstream tfep/potentials/mimic.py); rebuilt here around a
:class:`_CpmdDeck` parsed-input object and a staged single-point task
(prepare -> attempt loop -> policy resolution). The grompp input file is
written natively in .g96 format instead of via MDAnalysis.
"""

from __future__ import annotations

import copy
import glob
import os
import re
import subprocess
from typing import Dict, List, Optional, Tuple

import numpy as np

from tfep_tpu_torch.parallel.cli import CLITool
from tfep_tpu_torch.parallel.launcher import Launcher
from tfep_tpu_torch.potentials.engine import EnginePotential
from tfep_tpu_torch.potentials.gromacs import (
    GmxGrompp, GmxMdrun, _create_g96_file,
)
from tfep_tpu_torch.units import Quantity, ureg
from tfep_tpu_torch.utils.misc import clear_directory, temporary_cd

__all__ = ['MiMiCPotential', 'mimic_potential_energy', 'Cpmd']

# bohr -> nm conversion for the grompp .g96 input.
_BOHR_TO_NM = float(Quantity(1.0, ureg.bohr).to(ureg.nanometer).magnitude)


class Cpmd(CLITool):
    """The CPMD command: ``cpmd input.inp [pseudopotential_dir]``.

    >>> Cpmd('input.in', 'path/to/pseudo/').to_subprocess()
    ['cpmd', 'input.in', 'path/to/pseudo/']
    """
    EXECUTABLE_PATH = 'cpmd'


class MiMiCPotential(EnginePotential):
    """Differentiable QM/MM potential energy via MiMiC (CPMD + GROMACS).

    Runs the two coupled engines concurrently per frame (MPMD — one
    launcher call with both commands, as an ``srun --multi-prog`` job on
    clusters), rewriting the CPMD input's atom positions per sample and
    regenerating the ``.tpr`` via grompp; energies/forces are read from
    CPMD's ``ENERGIES``/``FTRAJECTORY`` files with the atom order mapped
    through the ``&MIMIC OVERLAPS`` block. Native units hartree/bohr.
    Reference: upstream tfep/potentials/mimic.py:93-405.

    Parameters
    ----------
    cpmd_cmd : Cpmd
        CPMD command; ``cpmd_cmd.args[0]`` is the template input file
        rewritten per sample.
    mdrun_cmd : GmxMdrun
        The GROMACS half of the MPMD pair.
    grompp_cmd : GmxGrompp
        Used to regenerate the ``.tpr`` per sample.
    launcher : Launcher, optional
        Launches the CPMD+mdrun pair concurrently (use
        :class:`~tfep_tpu_torch.parallel.SRunLauncher` for multi-node MPMD).
    positions_unit, energy_unit : Unit, optional
        User-facing units (defaults bohr / hartree).
    precompute_gradient : bool, optional
        Read forces together with the energy.
    working_dir_path : str or list of str, optional
        Scratch directory; a per-sample list keeps parallel frames from
        colliding on the engines' communication files.
    cleanup_working_dir : bool, optional
        Delete scratch directories after each evaluation.
    parallelization_strategy : ParallelizationStrategy, optional
        Per-sample fan-out.
    launcher_kwargs, grompp_launcher, grompp_launcher_kwargs : optional
        Launcher customization for the MPMD pair / the grompp step.
    n_attempts : int, optional
        Retries for crashes that leave no CPMD error file.
    on_unconverged : {'raise', 'success', 'nan'}, optional
        Policy when CPMD reports ``DENSITY NOT CONVERGED``.
    on_local_error : {'raise', 'nan'}, optional
        Policy when CPMD writes a ``LocalError-*.log``.
    """

    DEFAULT_ENERGY_UNIT = 'hartree'
    DEFAULT_POSITIONS_UNIT = 'bohr'
    ENGINE_ENERGY_UNIT = 'hartree'
    ENGINE_POSITIONS_UNIT = 'bohr'

    def __init__(self, cpmd_cmd: Cpmd, mdrun_cmd: GmxMdrun,
                 grompp_cmd: GmxGrompp,
                 launcher: Optional[Launcher] = None,
                 positions_unit=None, energy_unit=None,
                 precompute_gradient: bool = True,
                 working_dir_path=None,
                 cleanup_working_dir: bool = False,
                 parallelization_strategy=None,
                 launcher_kwargs: Optional[dict] = None,
                 grompp_launcher: Optional[Launcher] = None,
                 grompp_launcher_kwargs: Optional[dict] = None,
                 n_attempts: int = 1,
                 on_unconverged: str = 'raise',
                 on_local_error: str = 'raise'):
        """``cpmd_cmd.args[0]`` is the template CPMD input (rewritten per
        sample); ``working_dir_path`` may be a per-sample list so parallel
        frames don't collide on the communication files."""
        super().__init__(positions_unit=positions_unit,
                         energy_unit=energy_unit,
                         parallelization_strategy=parallelization_strategy,
                         precompute_gradient=precompute_gradient)
        if on_unconverged not in ('raise', 'nan', 'success'):
            raise ValueError(
                "on_unconverged must be 'raise', 'nan', or 'success'.")
        if on_local_error not in ('raise', 'nan'):
            raise ValueError("on_local_error must be 'raise' or 'nan'.")
        self.cpmd_cmd = cpmd_cmd
        self.mdrun_cmd = mdrun_cmd
        self.grompp_cmd = grompp_cmd
        self.launcher = launcher
        self.working_dir_path = working_dir_path
        self.cleanup_working_dir = cleanup_working_dir
        self.launcher_kwargs = launcher_kwargs
        self.grompp_launcher = grompp_launcher
        self.grompp_launcher_kwargs = grompp_launcher_kwargs
        self.n_attempts = n_attempts
        self.on_unconverged = on_unconverged
        self.on_local_error = on_local_error

    def _compute_batch(self, positions: np.ndarray,
                       cell: Optional[np.ndarray], compute_forces: bool):
        task_args = []
        for i in range(positions.shape[0]):
            box = None if cell is None else np.asarray(cell[i])[:3]
            task_args.append((
                self.cpmd_cmd, self.mdrun_cmd, self.grompp_cmd,
                self.grompp_launcher, compute_forces,
                self.cleanup_working_dir, self.launcher_kwargs,
                self.grompp_launcher_kwargs, self.n_attempts,
                self.on_unconverged, self.on_local_error,
                positions[i].reshape(-1, 3), box, self.launcher,
                self._sample_working_dir(i)))
        results = self.parallelization_strategy.run(_run_mimic_task,
                                                    task_args)
        energies = np.asarray([r[0] for r in results])
        forces = (np.stack([r[1].reshape(-1) for r in results])
                  if compute_forces else None)
        return energies, forces


# =============================================================================
# CPMD input deck (engine-independent; tested without the engine)
# =============================================================================

def _split_sections(lines) -> Dict[str, List[int]]:
    """Group file rows by the ``&SECTION`` they belong to.

    Returns ``{section_name: [row, ...]}`` with rows in file order; the
    section header and ``&END`` rows themselves are excluded.
    """
    sections: Dict[str, List[int]] = {}
    current = None
    for row, raw in enumerate(lines):
        word = raw.strip().upper()
        if word.startswith('&'):
            current = None if word == '&END' else word
            continue
        if current is not None:
            sections.setdefault(current, []).append(row)
    return sections


class _CpmdDeck:
    """A CPMD input file parsed into the pieces MiMiC needs to rewrite.

    Attributes
    ----------
    lines : list of str
        Raw file lines (mutated in place by the ``set_*`` methods).
    paths_row : int or None
        Row holding the &MIMIC working-directory path (two rows below the
        ``PATHS`` keyword: keyword, layer count, then the path itself).
    box_row : int or None
        Row holding the &MIMIC BOX vector.
    overlap_map : dict
        GROMACS atom index -> CPMD atom index (0-based), from the
        ``OVERLAPS`` table. Each table row is ``code_a idx_a code_b idx_b``
        with 1-based indices; code 2 marks the GROMACS side.
    coord_rows : list of int
        Row of the coordinate line of each CPMD atom, in CPMD order
        (accumulated across the per-species ``*`` groups of &ATOMS).
    """

    def __init__(self, path: str):
        with open(path) as f:
            self.lines = f.readlines()
        self.paths_row: Optional[int] = None
        self.box_row: Optional[int] = None
        self.overlap_map: Dict[int, int] = {}
        self.coord_rows: List[int] = []

        sections = _split_sections(self.lines)
        if '&MIMIC' in sections:
            self._scan_mimic(sections['&MIMIC'])
        if '&ATOMS' in sections:
            self._scan_atoms(sections['&ATOMS'])

    def _scan_mimic(self, rows: List[int]):
        at = 0
        while at < len(rows):
            keyword = self.lines[rows[at]].split()
            keyword = keyword[0].upper() if keyword else ''
            if keyword == 'PATHS':
                self.paths_row = rows[at + 2]
                at += 3
            elif keyword == 'BOX':
                self.box_row = rows[at + 1]
                at += 2
            elif keyword == 'OVERLAPS':
                n_entries = int(self.lines[rows[at + 1]])
                for entry_row in rows[at + 2:at + 2 + n_entries]:
                    code_a, idx_a, _, idx_b = \
                        self.lines[entry_row].split()[:4]
                    pair = (int(idx_a) - 1, int(idx_b) - 1)
                    if code_a == '1':  # CPMD side listed first
                        cpmd_idx, gromacs_idx = pair
                    else:
                        gromacs_idx, cpmd_idx = pair
                    self.overlap_map[gromacs_idx] = cpmd_idx
                at += 2 + n_entries
            else:
                at += 1

    def _scan_atoms(self, rows: List[int]):
        at = 0
        while at < len(rows):
            if self.lines[rows[at]].lstrip().startswith('*'):
                # Species group: pseudopotential line, nonlocality line,
                # atom count, then one coordinate line per atom.
                n_atoms = int(self.lines[rows[at + 2]])
                self.coord_rows.extend(rows[at + 3:at + 3 + n_atoms])
                at += 3 + n_atoms
            else:
                at += 1

    # -- rewriting ------------------------------------------------------ #
    def retarget(self, working_dir_path: str) -> bool:
        """Point &MIMIC.PATHS at ``working_dir_path`` (no-op if already)."""
        if self.paths_row is None:
            return False
        current = self.lines[self.paths_row].strip()
        if os.path.realpath(current) == working_dir_path:
            return False
        self.lines[self.paths_row] = working_dir_path + '\n'
        return True

    def set_box(self, box_bohr):
        if self.box_row is not None:
            self.lines[self.box_row] = \
                ' '.join(str(x) for x in box_bohr) + '\n'

    def set_qm_positions(self, positions_bohr):
        """Write the QM atoms' coordinates (GROMACS-ordered full-system
        positions in) into the &ATOMS block via the overlap map."""
        for gromacs_idx, cpmd_idx in self.overlap_map.items():
            row = self.coord_rows[cpmd_idx]
            self.lines[row] = \
                ' '.join(str(x) for x in positions_bohr[gromacs_idx]) + '\n'

    def write(self, path: str):
        with open(path, 'w') as f:
            f.writelines(self.lines)


def _parse_cpmd_input(cpmd_input_file_path):
    """Parse a CPMD input file (compatibility tuple view of _CpmdDeck)."""
    deck = _CpmdDeck(cpmd_input_file_path)
    return (deck.lines, deck.paths_row, deck.box_row, deck.overlap_map,
            deck.coord_rows)


# =============================================================================
# CPMD output readers
# =============================================================================

def _read_first_energy(cpmd_dir_path):
    """First-step energy (hartree) from the CPMD ENERGIES trajectory file."""
    with open(os.path.join(cpmd_dir_path, 'ENERGIES')) as f:
        for line in f:
            fields = line.split()
            if int(fields[0]) == 1:
                return float(fields[3])
    raise FileNotFoundError('No step-1 energy found in ENERGIES.')


def _read_first_force(cpmd_dir_path, gromacs_to_cpmd_atom_indices):
    """First-step forces (hartree/bohr) from FTRAJECTORY, GROMACS-ordered.

    FTRAJECTORY rows are ``step x y z vx vy vz fx fy fz`` in CPMD atom
    order; the overlap map relabels rows back to GROMACS order (atoms
    absent from the map keep their position).
    """
    step1 = []
    with open(os.path.join(cpmd_dir_path, 'FTRAJECTORY')) as f:
        for line in f:
            fields = line.split()
            if fields and fields[0] == '1':
                step1.append(fields[7:10])
    forces_cpmd = np.asarray(step1, dtype=float)
    rows = np.arange(len(forces_cpmd))
    for gromacs_idx, cpmd_idx in gromacs_to_cpmd_atom_indices.items():
        rows[gromacs_idx] = cpmd_idx
    return forces_cpmd[rows]


# =============================================================================
# Single-point task
# =============================================================================

def _prepare_cpmd_command(cpmd_cmd, working_dir_path, positions_bohr=None,
                          box_bohr=None):
    """Stage the per-sample CPMD input inside the working directory.

    Rewrites &MIMIC.PATHS to the working dir and, when positions are
    given, the box vector and QM coordinates. Returns the (possibly
    re-pointed) Cpmd command and the GROMACS->CPMD overlap map.
    """
    staged_name = 'cpmd.inp'

    # The template path in the command may be relative to the working dir.
    with temporary_cd(working_dir_path):
        template_path = os.path.realpath(cpmd_cmd.args[0])
    deck = _CpmdDeck(template_path)

    dirty = deck.retarget(working_dir_path)
    if positions_bohr is not None:
        if box_bohr is not None:
            deck.set_box(box_bohr)
        deck.set_qm_positions(positions_bohr)
        dirty = True

    if dirty:
        deck.write(os.path.join(working_dir_path, staged_name))
        cpmd_cmd = copy.deepcopy(cpmd_cmd)
        cpmd_cmd.args = (staged_name,) + tuple(cpmd_cmd.args[1:])

    return cpmd_cmd, deck.overlap_map


def _prepare_mdrun_command(mdrun_cmd, grompp_cmd, working_dir_path,
                           positions_bohr=None, box_bohr=None,
                           grompp_launcher=None, **kwargs):
    """Regenerate the .tpr via grompp with the new positions (.g96 input)."""
    if positions_bohr is None:
        return mdrun_cmd

    conf_name, tpr_name = 'configuration.g96', 'gromacs.tpr'
    positions_nm = np.asarray(positions_bohr) * _BOHR_TO_NM
    box_nm = (None if box_bohr is None
              else np.diag(np.asarray(box_bohr) * _BOHR_TO_NM))
    _create_g96_file(working_dir_path, positions_nm, box_nm)

    grompp_cmd = copy.deepcopy(grompp_cmd)
    grompp_cmd.start_traj_path = conf_name
    grompp_cmd.tpr_path = tpr_name
    (grompp_launcher or Launcher()).run(
        grompp_cmd, cwd=working_dir_path, **kwargs)

    mdrun_cmd = copy.deepcopy(mdrun_cmd)
    mdrun_cmd.tpr_path = tpr_name
    return mdrun_cmd


def _run_mimic_task(cpmd_cmd, mdrun_cmd, grompp_cmd, grompp_launcher,
                    return_forces, cleanup_working_dir, launcher_kwargs,
                    grompp_launcher_kwargs, n_attempts, on_unconverged,
                    on_local_error, positions_bohr, box_bohr, launcher,
                    working_dir_path):
    """One MiMiC single point (bohr in, hartree out) with retries.

    Stages: prepare the per-sample inputs, run the CPMD+mdrun pair up to
    ``n_attempts`` times, classify the outcome (``ok`` / ``unconverged`` /
    ``local_error``), then apply the configured failure policy.
    """
    launcher_kwargs = dict(launcher_kwargs or {})

    watch_convergence = on_unconverged != 'success'
    if watch_convergence and \
            launcher_kwargs.get('stdout') != subprocess.PIPE:
        raise ValueError(
            f"If on_unconverged={on_unconverged}, then 'launcher_kwargs' "
            'must include stdout=subprocess.PIPE')

    working_dir_path = os.path.realpath(working_dir_path or os.getcwd())

    # -- prepare -------------------------------------------------------- #
    cpmd_cmd, overlap_map = _prepare_cpmd_command(
        cpmd_cmd, working_dir_path, positions_bohr, box_bohr)
    mdrun_cmd = _prepare_mdrun_command(
        mdrun_cmd, grompp_cmd, working_dir_path, positions_bohr, box_bohr,
        grompp_launcher, **(grompp_launcher_kwargs or {}))
    launcher = launcher or Launcher()

    # -- attempt loop --------------------------------------------------- #
    # MiMiC's file-based communication is fragile: a crash before the
    # ENERGIES file is written surfaces as FileNotFoundError. A crash that
    # left a LocalError log is a real engine failure (no retry); anything
    # else gets retried up to n_attempts times.
    status = 'ok'
    energy, forces = None, None
    for attempts_left in reversed(range(n_attempts)):
        try:
            outputs = launcher.run(cpmd_cmd, mdrun_cmd,
                                   cwd=working_dir_path, **launcher_kwargs)
            cpmd_output = outputs[0] if isinstance(outputs, list) else outputs

            if (watch_convergence and cpmd_output.stdout is not None
                    and re.search(b'DENSITY NOT CONVERGED',
                                  cpmd_output.stdout)):
                status = 'unconverged'
            else:
                energy = _read_first_energy(working_dir_path)
                if return_forces:
                    forces = _read_first_force(working_dir_path, overlap_map)
            break
        except FileNotFoundError:
            if glob.glob(os.path.join(working_dir_path, 'LocalError-*.log')):
                status = 'local_error'
                break
            if attempts_left == 0:
                raise RuntimeError('Cannot run MiMiC.')

    # -- policy resolution ---------------------------------------------- #
    policy = {'ok': None, 'unconverged': on_unconverged,
              'local_error': on_local_error}[status]
    if policy == 'nan':
        energy = np.nan
        forces = np.zeros_like(positions_bohr) if return_forces else None
    elif policy is not None:
        raise RuntimeError(
            'The self consistent calculation did not converge.'
            if status == 'unconverged'
            else 'Detected LocalError-X-X-X.log file.')

    if cleanup_working_dir:
        clear_directory(working_dir_path)

    return energy, forces


def mimic_potential_energy(batch_positions, cpmd_cmd, mdrun_cmd, grompp_cmd,
                           batch_cell=None, launcher=None,
                           positions_unit=None, energy_unit=None,
                           precompute_gradient=True, working_dir_path=None,
                           cleanup_working_dir=False,
                           parallelization_strategy=None,
                           launcher_kwargs=None, grompp_launcher=None,
                           grompp_launcher_kwargs=None, n_attempts=1,
                           on_unconverged='raise', on_local_error='raise'):
    """Functional form of :class:`MiMiCPotential`.

    Returns differentiable per-sample energies from a coupled CPMD+GROMACS
    (MiMiC) QM/MM evaluation. Prefer the class for repeated
    evaluation. Reference: upstream tfep/potentials/mimic.py.
    """
    potential = MiMiCPotential(
        cpmd_cmd, mdrun_cmd, grompp_cmd, launcher=launcher,
        positions_unit=positions_unit, energy_unit=energy_unit,
        precompute_gradient=precompute_gradient,
        working_dir_path=working_dir_path,
        cleanup_working_dir=cleanup_working_dir,
        parallelization_strategy=parallelization_strategy,
        launcher_kwargs=launcher_kwargs, grompp_launcher=grompp_launcher,
        grompp_launcher_kwargs=grompp_launcher_kwargs, n_attempts=n_attempts,
        on_unconverged=on_unconverged, on_local_error=on_local_error)
    return potential(batch_positions, batch_cell)
