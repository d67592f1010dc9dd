"""Task functions for the port's tests of spawned process pools.

A spawned worker imports the module of each task it unpickles, so these
live apart from the test files, which import JAX: a worker that runs them
imports only numpy and the port's engine module.
"""

import sys

import numpy as np

from tfep_tpu_torch.potentials.ase import _run_ase_task


class QuadraticAtoms:
    """A picklable stand-in for ``ase.Atoms`` (energy |x|^2)."""

    def set_positions(self, positions):
        self.positions = np.asarray(positions)

    def get_potential_energy(self):
        return float(np.sum(self.positions ** 2))

    def get_forces(self):
        return -2.0 * self.positions


def ase_task_and_modules(positions):
    """``_run_ase_task`` on a :class:`QuadraticAtoms`, and the names of
    the modules the worker has imported."""
    energy, forces = _run_ase_task(QuadraticAtoms(), positions, None, True)
    return energy, forces, sorted(sys.modules)
