"""ASE potential: any ``ase.calculators`` Calculator as a TFEP target.

A copy of ``tfep_tpu/potentials/ase.py``: the port keeps its own,
because importing the JAX package's module would import JAX.

Engine units eV/angstrom; per-sample tasks deep-copy the template ``Atoms``
so process pools are safe; 3/6-vector or 3x3 cells supported. Reference
behaviors: upstream tfep/potentials/ase.py:43-401.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np

from tfep_tpu_torch.potentials.engine import EnginePotential

__all__ = ['ASEPotential', 'ase_potential_energy']

try:
    import ase  # noqa: F401
    ASE_INSTALLED = True
except ImportError:
    ASE_INSTALLED = False


class ASEPotential(EnginePotential):
    """Differentiable potential energy via an ASE calculator.

    Any calculator implementing the ``ase.calculators`` interface (EMT,
    LAMMPS, VASP, machine-learned potentials, ...) becomes a TFEP target
    potential. A template ``ase.Atoms`` is built once from the
    constructor arguments; each batch sample deep-copies it, sets the
    sample's positions (and unit cell, when the dataset provides one),
    and runs a single-point evaluation — deep-copying keeps tasks
    process-pool safe even for stateful calculators.

    Parameters
    ----------
    calculator : ase.calculators.calculator.Calculator
        The calculator attached to the template atoms.
    symbols, numbers, pbc, **atoms_kwargs
        Forwarded to ``ase.Atoms`` to define the chemical system.
    positions_unit, energy_unit : pint units, optional
        Caller-side units (default angstrom / eV).
    parallelization_strategy : ParallelizationStrategy, optional
        How per-sample tasks are distributed (default serial).
    precompute_gradient : bool, optional
        Compute forces with energies in one engine call.
    """

    DEFAULT_ENERGY_UNIT = 'eV'
    DEFAULT_POSITIONS_UNIT = 'angstrom'
    ENGINE_ENERGY_UNIT = 'eV'
    ENGINE_POSITIONS_UNIT = 'angstrom'

    def __init__(self, calculator=None, symbols=None, numbers=None, pbc=None,
                 positions_unit=None, energy_unit=None,
                 parallelization_strategy=None, precompute_gradient=True,
                 atoms=None, **atoms_kwargs):
        if not ASE_INSTALLED:
            raise ImportError(
                'ASEPotential requires the ase package to be installed.')
        from ase import Atoms

        super().__init__(positions_unit=positions_unit,
                         energy_unit=energy_unit,
                         parallelization_strategy=parallelization_strategy,
                         precompute_gradient=precompute_gradient)
        if atoms is not None:
            # Pre-built template (the reference's calling convention,
            # upstream tfep/potentials/ase.py:323-330): use it as-is,
            # attaching the calculator when one is given separately.
            if (symbols is not None or numbers is not None
                    or pbc is not None or atoms_kwargs):
                raise ValueError(
                    'Pass either a template "atoms" object or the ase.Atoms '
                    'constructor arguments, not both.')
            if calculator is not None:
                # Attach on a copy: the caller's template must not lose its
                # own calculator as a side effect.
                atoms = copy.copy(atoms)
                atoms.calc = calculator
            self.atoms = atoms
        else:
            if calculator is None:
                raise ValueError('A calculator is required when no template '
                                 '"atoms" object is given.')
            self.atoms = Atoms(symbols=symbols, numbers=numbers, pbc=pbc,
                               calculator=calculator, **atoms_kwargs)

    def _compute_batch(self, positions: np.ndarray,
                       cell: Optional[np.ndarray], compute_forces: bool):
        n_samples = positions.shape[0]
        task_args = []
        for i in range(n_samples):
            sample_cell = None if cell is None else cell[i]
            task_args.append((self.atoms, positions[i], sample_cell,
                              compute_forces))
        results = self.parallelization_strategy.run(_run_ase_task, task_args)
        energies = np.asarray([r[0] for r in results])
        forces = (np.stack([r[1] for r in results])
                  if compute_forces else None)
        return energies, forces


def _run_ase_task(template_atoms, positions, cell, compute_forces):
    """Single-point ASE evaluation (engine units). Pool-safe via deepcopy."""
    atoms = copy.deepcopy(template_atoms)
    atoms.set_positions(positions.reshape(-1, 3))
    if cell is not None:
        # 3x3 matrix, 3-vector (orthorhombic), or 6-vector (lengths+angles).
        atoms.set_cell(np.asarray(cell))
    energy = atoms.get_potential_energy()
    if compute_forces:
        forces = atoms.get_forces().reshape(-1)
        return energy, forces
    return energy, None


def ase_potential_energy(batch_positions, atoms, batch_cell=None,
                         positions_unit=None, energy_unit=None,
                         parallelization_strategy=None,
                         precompute_gradient=True):
    """Functional form of :class:`ASEPotential`.

    ``atoms`` is a template ``ase.Atoms`` with a calculator attached;
    returns differentiable per-sample energies (the backward pass is
    ``-forces * g`` through the autograd bridge). For repeated
    evaluation, construct an :class:`ASEPotential` once instead: each call
    here builds a new potential and its autograd Function.
    Reference: upstream tfep/potentials/ase.py:323-351.
    """
    potential = ASEPotential(
        atoms=atoms, positions_unit=positions_unit, energy_unit=energy_unit,
        parallelization_strategy=parallelization_strategy,
        precompute_gradient=precompute_gradient)
    return potential(batch_positions, batch_cell)
