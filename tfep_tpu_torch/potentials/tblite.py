"""TBLite potential: semi-empirical extended tight-binding (GFN-xTB).

A copy of ``tfep_tpu/potentials/tblite.py``: the port keeps its own,
because importing the JAX package's module would import JAX.

Engine units hartree/bohr; ``return_nan_on_failure`` turns unconverged SCF
into NaN energies (zero forces), handled downstream by
``BoltzmannKLDivLoss(ignore_nan=True)``. Note tblite returns *gradients*
(dE/dx), i.e. negative forces. Reference behaviors:
upstream tfep/potentials/tblite.py:52-406.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tfep_tpu_torch.potentials.engine import EnginePotential

__all__ = ['TBLitePotential', 'tblite_potential_energy']

try:
    import tblite  # noqa: F401
    TBLITE_INSTALLED = True
except ImportError:
    TBLITE_INSTALLED = False


class TBLitePotential(EnginePotential):
    """Differentiable potential energy via tblite.

    Wraps the ``tblite`` Python interface as an
    :class:`~tfep_tpu_torch.potentials.engine.EnginePotential`: inside a
    training step the energy is computed on the host, where
    each sample of the batch is evaluated as an independent single-point
    calculation (optionally fanned out over a
    :class:`~tfep_tpu_torch.parallel.ParallelizationStrategy` process pool),
    and gradients flow through the engine's analytic forces via
    the bridge's autograd Function.

    Parameters
    ----------
    method : str
        xTB Hamiltonian, e.g. ``'GFN2-xTB'`` or ``'GFN1-xTB'``.
    numbers : array-like of int
        Atomic numbers, shape ``(n_atoms,)``.
    positions_unit, energy_unit : pint units, optional
        Units of the caller's positions / returned energies (default
        bohr / hartree; conversion to the engine's units is automatic).
    precompute_gradient : bool, optional
        Compute forces together with energies in the forward pass (one
        engine call per step instead of two).
    parallelization_strategy : ParallelizationStrategy, optional
        How the per-sample tasks are distributed (default serial).
    verbosity : int, optional
        tblite verbosity level.
    return_nan_on_failure : bool, optional
        Turn unconverged-SCF RuntimeErrors into NaN energies (with zero
        forces) instead of raising.
    """

    DEFAULT_ENERGY_UNIT = 'hartree'
    DEFAULT_POSITIONS_UNIT = 'bohr'
    ENGINE_ENERGY_UNIT = 'hartree'
    ENGINE_POSITIONS_UNIT = 'bohr'

    def __init__(self, method: str, numbers,
                 positions_unit=None, energy_unit=None,
                 precompute_gradient: bool = True,
                 parallelization_strategy=None,
                 verbosity: int = 0,
                 return_nan_on_failure: bool = False):
        if not TBLITE_INSTALLED:
            raise ImportError(
                'TBLitePotential requires the tblite package to be installed.')
        super().__init__(positions_unit=positions_unit,
                         energy_unit=energy_unit,
                         parallelization_strategy=parallelization_strategy,
                         precompute_gradient=precompute_gradient)
        self.method = method
        self.numbers = np.asarray(numbers)
        self.verbosity = verbosity
        self.return_nan_on_failure = return_nan_on_failure

    def _compute_batch(self, positions: np.ndarray,
                       cell: Optional[np.ndarray], compute_forces: bool):
        task_args = [
            (self.method, self.numbers, compute_forces, self.verbosity,
             self.return_nan_on_failure, positions[i].reshape(-1, 3))
            for i in range(positions.shape[0])
        ]
        results = self.parallelization_strategy.run(
            _run_single_point, task_args)
        energies = np.asarray([r[0] for r in results])
        if compute_forces:
            # tblite returns gradients; forces = -gradient.
            forces = -np.stack([r[1].reshape(-1) for r in results])
            return energies, forces
        return energies, None


def _run_single_point(method, numbers, return_gradients, verbosity,
                      return_nan_on_failure, positions):
    """One tblite single point (bohr in, hartree out). Pool-safe task fn."""
    from tblite.interface import Calculator

    calc = Calculator(method, numbers, positions)
    calc.set('verbosity', verbosity)
    try:
        res = calc.singlepoint()
    except RuntimeError:
        if return_nan_on_failure:
            return (np.nan, np.zeros_like(positions)) if return_gradients \
                else (np.nan, None)
        raise

    energy = res.get('energy')
    if return_gradients:
        return energy, res.get('gradient')
    return energy, None


def tblite_potential_energy(batch_positions, method, numbers,
                            positions_unit=None, energy_unit=None,
                            parallelization_strategy=None,
                            precompute_gradient=True, verbosity=0,
                            return_nan_on_failure=False):
    """Functional form of :class:`TBLitePotential`.

    Returns differentiable per-sample energies for a tblite method (e.g.
    ``'GFN2-xTB'``). Prefer the class for repeated evaluation.
    Reference: upstream tfep/potentials/tblite.py.
    """
    potential = TBLitePotential(
        method, numbers, positions_unit=positions_unit,
        energy_unit=energy_unit,
        parallelization_strategy=parallelization_strategy,
        precompute_gradient=precompute_gradient, verbosity=verbosity,
        return_nan_on_failure=return_nan_on_failure)
    return potential(batch_positions)
