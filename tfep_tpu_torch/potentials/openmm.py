"""OpenMM potential: classical MM energies/forces via the OpenMM Context.

A copy of ``tfep_tpu/potentials/openmm.py``: the port keeps its own,
because importing the JAX package's module would import JAX.

Engine units kJ/mol and nanometer. Contexts are expensive to build, so a
process-wide :class:`ContextPool` (exposed as ``global_context_cache`` for
reference-API parity, upstream tfep/potentials/openmm.py) hands out
one reusable Context per named system — including inside pool workers,
where each process builds its own on first use. ``batch_cell`` rows are
interpreted as box lengths/vectors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tfep_tpu_torch.potentials.engine import EnginePotential

__all__ = ['OpenMMPotential', 'openmm_potential_energy',
           'global_context_cache']

try:
    import openmm  # noqa: F401
    OPENMM_INSTALLED = True
except ImportError:
    OPENMM_INSTALLED = False


def _build_context(system, platform_name, platform_properties):
    from openmm import Context, Platform, VerletIntegrator

    # The integrator is never stepped (single points only).
    integrator = VerletIntegrator(0.001)
    if platform_name is None:
        return Context(system, integrator)
    platform = Platform.getPlatformByName(platform_name)
    for prop, value in (platform_properties or {}).items():
        platform.setPropertyDefaultValue(prop, value)
    return Context(system, integrator, platform)


class ContextPool(dict):
    """Named-system Context store (a dict keyed by ``system_name``).

    ``acquire`` returns the cached Context for a name, building (and, if
    the name is not None, retaining) one from the given system otherwise.
    """

    def acquire(self, system_name, system, platform_name=None,
                platform_properties=None):
        if system_name in self:
            return self[system_name]
        if system is None:
            raise KeyError(
                f'No cached OpenMM Context named {system_name!r} and no '
                'System to build one from.')
        context = _build_context(system, platform_name, platform_properties)
        if system_name is not None:
            self[system_name] = context
        return context


#: Process-wide Context store, keyed by system_name.
global_context_cache = ContextPool()


def _as_box_vectors(cell_row):
    """One batch_cell row -> (3, 3) box vectors (engine units)."""
    cell_row = np.asarray(cell_row)
    if cell_row.shape == (3, 3):
        return cell_row
    if cell_row.shape == (3,):
        return np.diag(cell_row)
    if cell_row.shape == (6,):
        # Lengths + angles: only orthorhombic boxes supported here.
        return np.diag(cell_row[:3])
    raise ValueError(f'Unsupported cell shape {cell_row.shape}.')


class OpenMMPotential(EnginePotential):
    """Differentiable potential energy via an OpenMM System.

    Molecular-mechanics target potential through the ``openmm`` Python
    bindings (reference: upstream tfep/potentials/openmm.py:45-190).
    Native units kJ/mol / nanometer.

    Parameters
    ----------
    system : openmm.System
        The force field + topology to evaluate.
    positions_unit, energy_unit : Unit, optional
        User-facing units (defaults nanometer / kJ/mol).
    platform_name : str, optional
        OpenMM Platform (e.g. ``'CPU'``, ``'CUDA'``); OpenMM's default
        when ``None``.
    platform_properties : dict, optional
        Platform-specific properties (e.g. thread counts).
    system_name : str, optional
        Key into the global Context cache: passing a name reuses the same
        ``openmm.Context`` across batches instead of rebuilding it
        (reference's ``global_context_cache``, openmm.py:38).
    parallelization_strategy : ParallelizationStrategy, optional
        Per-sample fan-out within a batch.
    precompute_gradient : bool, optional
        Fetch forces together with the energy for the backward pass.
    """

    DEFAULT_ENERGY_UNIT = 'kilojoule_per_mole'
    DEFAULT_POSITIONS_UNIT = 'nanometer'
    ENGINE_ENERGY_UNIT = 'kilojoule_per_mole'
    ENGINE_POSITIONS_UNIT = 'nanometer'

    def __init__(self, system, positions_unit=None, energy_unit=None,
                 platform_name: Optional[str] = None,
                 platform_properties: Optional[dict] = None,
                 system_name: Optional[str] = None,
                 parallelization_strategy=None,
                 precompute_gradient: bool = True):
        """``system`` is an ``openmm.System``; ``system_name`` keys the
        global Context cache (pass one to reuse Contexts across batches)."""
        if not OPENMM_INSTALLED:
            raise ImportError(
                'OpenMMPotential requires the openmm package to be installed.')
        super().__init__(positions_unit=positions_unit,
                         energy_unit=energy_unit,
                         parallelization_strategy=parallelization_strategy,
                         precompute_gradient=precompute_gradient)
        self.system = system
        self.platform_name = platform_name
        self.platform_properties = platform_properties or {}
        self.system_name = system_name

    def _compute_batch(self, positions: np.ndarray,
                       cell: Optional[np.ndarray], compute_forces: bool):
        task_args = [
            (self.system, self.platform_name, self.platform_properties,
             self.system_name, compute_forces,
             positions[i].reshape(-1, 3),
             None if cell is None else _as_box_vectors(cell[i]))
            for i in range(positions.shape[0])]
        results = self.parallelization_strategy.run(
            _run_single_point_calculation, task_args)
        energies = np.asarray([r[0] for r in results])
        forces = (np.stack([np.asarray(r[1]).reshape(-1) for r in results])
                  if compute_forces else None)
        return energies, forces


def _run_single_point_calculation(system, platform_name, platform_properties,
                                  system_name, return_forces, positions,
                                  box_vectors):
    """One OpenMM single point (nm in, kJ/mol out), Context cached."""
    context = global_context_cache.acquire(
        system_name, system, platform_name, platform_properties)

    if box_vectors is not None:
        context.setPeriodicBoxVectors(*box_vectors)
    context.setPositions(positions)
    state = context.getState(getEnergy=True, getForces=return_forces)

    energy = state.getPotentialEnergy()._value
    if return_forces:
        return energy, state.getForces(asNumpy=True)._value
    return energy, None


def openmm_potential_energy(batch_positions, system, batch_cell=None,
                            positions_unit=None, energy_unit=None,
                            platform_name=None, platform_properties=None,
                            system_name=None, parallelization_strategy=None,
                            precompute_gradient=True):
    """Functional form of :class:`OpenMMPotential`.

    Returns differentiable per-sample energies for an ``openmm.System``.
    Prefer the class for repeated evaluation (one potential, one
    autograd Function). Reference: upstream tfep/potentials/openmm.py.
    """
    potential = OpenMMPotential(
        system, positions_unit=positions_unit, energy_unit=energy_unit,
        platform_name=platform_name, platform_properties=platform_properties,
        system_name=system_name,
        parallelization_strategy=parallelization_strategy,
        precompute_gradient=precompute_gradient)
    return potential(batch_positions, batch_cell)
