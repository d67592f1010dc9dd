"""Engine potential base: host engines as differentiable device functions.

Port of ``tfep_tpu/potentials/engine.py``. Subclasses implement
``_compute_batch(positions, cell) -> (energies, forces)``
on the host in *engine* units with numpy inputs; this base handles
- unit conversion user<->engine (positions in ``positions_unit``, energies
  out in ``energy_unit``, forces in ``energy_unit/positions_unit``);
- per-sample fan-out via a ParallelizationStrategy;
- the autograd bridge (:mod:`tfep_tpu_torch.potentials.bridge`) so the
  potential can be called on device tensors inside a training step
  (backward = ``-forces * g``);
- ``precompute_gradient`` (compute forces in the same engine evaluation as
  the energy) and NaN failure policies, mirroring the reference autograd
  Functions (upstream tfep/potentials/ase.py:168-320).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tfep_tpu_torch.parallel.strategies import (
    ParallelizationStrategy, SerialStrategy,
)
from tfep_tpu_torch.potentials.base import PotentialBase
from tfep_tpu_torch.potentials.bridge import make_callback_potential
from tfep_tpu_torch.units import Quantity, ureg

__all__ = ['EnginePotential']


class EnginePotential(PotentialBase):
    """Base class for external-engine potentials.

    Calling the instance on device tensors is differentiable: the
    positions are copied to the host once, and when they need a gradient
    the engine computes the forces in the same evaluation, which the
    backward injects as ``-forces * g`` without a second engine
    round-trip. Without a gradient the energy-only host call is used.

    Parameters
    ----------
    positions_unit, energy_unit : Unit, optional
        User-facing units (class defaults when ``None``); conversion
        to/from the engine-native ``ENGINE_*_UNIT`` is handled here.
    parallelization_strategy : ParallelizationStrategy, optional
        How per-sample engine tasks fan out within a batch (default
        :class:`~tfep_tpu_torch.parallel.SerialStrategy`).
    precompute_gradient : bool, optional
        Compute forces in the same engine evaluation as the energy so the
        backward pass needs no extra engine call (default ``True``,
        matching the reference).
    """

    #: Engine-native units (registry attribute names), set by subclasses.
    ENGINE_ENERGY_UNIT: str = ''
    ENGINE_POSITIONS_UNIT: str = ''

    def __init__(self, positions_unit=None, energy_unit=None,
                 parallelization_strategy: Optional[ParallelizationStrategy] = None,
                 precompute_gradient: bool = True):
        super().__init__(positions_unit=positions_unit,
                         energy_unit=energy_unit)
        if parallelization_strategy is None:
            parallelization_strategy = SerialStrategy()
        self.parallelization_strategy = parallelization_strategy
        self.precompute_gradient = precompute_gradient
        self._callback_fns = {}
        self._current_sample_keys = None

        # Cache unit-conversion factors (user <-> engine).
        engine_energy = getattr(ureg, self.ENGINE_ENERGY_UNIT)
        engine_positions = getattr(ureg, self.ENGINE_POSITIONS_UNIT)
        self._pos_to_engine = float(
            Quantity(1.0, self.positions_unit).to(engine_positions).magnitude)
        self._energy_from_engine = float(
            Quantity(1.0, engine_energy).to(self.energy_unit).magnitude)
        # Force conversion: (E_engine / L_engine) -> (energy_unit / positions_unit).
        self._force_from_engine = self._energy_from_engine * self._pos_to_engine

    def _sample_working_dir(self, sample_idx: int):
        """Working dir for one batch sample (file-based backends declare a
        ``working_dir_path`` attribute, optionally a per-sample list)."""
        working_dir = getattr(self, 'working_dir_path', None)
        if isinstance(working_dir, (list, tuple)):
            return working_dir[sample_idx]
        return working_dir

    # ------------------------------------------------------------------ #
    # Subclass interface (engine units, numpy).
    # ------------------------------------------------------------------ #
    def _compute_batch(self, positions: np.ndarray,
                       cell: Optional[np.ndarray],
                       compute_forces: bool):
        """Compute energies (and forces when requested) for a batch.

        ``positions``: (batch, n_dofs) in ENGINE_POSITIONS_UNIT. Returns
        ``(energies, forces_or_None)`` in engine units; forces flattened
        ``(batch, n_dofs)``.
        """
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # Host entry points in user units.
    # ------------------------------------------------------------------ #
    def compute_energies_and_forces(self, positions, cell=None,
                                    sample_keys=None):
        dtype = np.asarray(positions).dtype    # caller dtype, restored below
        positions = np.asarray(positions, dtype=np.float64)
        engine_positions = positions * self._pos_to_engine
        engine_cell = (None if cell is None
                       else np.asarray(cell, np.float64) * self._pos_to_engine)
        self._stage_sample_keys(sample_keys)
        energies, forces = self._compute_batch(
            engine_positions, engine_cell, compute_forces=True)
        energies = np.asarray(energies, dtype) * self._energy_from_engine
        forces = np.asarray(forces, dtype).reshape(positions.shape) \
            * self._force_from_engine
        return energies, forces

    def compute_energies(self, positions, cell=None, sample_keys=None):
        dtype = np.asarray(positions).dtype    # caller dtype, restored below
        positions = np.asarray(positions, dtype=np.float64)
        engine_positions = positions * self._pos_to_engine
        engine_cell = (None if cell is None
                       else np.asarray(cell, np.float64) * self._pos_to_engine)
        self._stage_sample_keys(sample_keys)
        energies, _ = self._compute_batch(
            engine_positions, engine_cell, compute_forces=False)
        return np.asarray(energies, dtype) * self._energy_from_engine

    # ------------------------------------------------------------------ #
    # Per-sample keys (e.g. trajectory sample indices).
    # ------------------------------------------------------------------ #
    #: Whether __call__ should be given per-sample integer keys (e.g.
    #: ``batch['trajectory_sample_index']``). Backends that key per-frame
    #: state (like Psi4 SCF restart files) set this True.
    uses_sample_keys: bool = False

    def _stage_sample_keys(self, sample_keys):
        """Record this batch's per-sample keys for ``_compute_batch``.

        The keys reach the host call together with the positions, so they
        can never desynchronize from the batch (the port keeps a batch's
        sample indices on the host).
        """
        self._current_sample_keys = (
            None if sample_keys is None
            else np.asarray(sample_keys).astype(np.int64))

    # ------------------------------------------------------------------ #
    # Device entry point.
    # ------------------------------------------------------------------ #
    def __call__(self, batch_positions, batch_cell=None, sample_keys=None):
        """Differentiable per-sample energies of device (or host)
        tensors, in the positions' dtype and on their device."""
        has_cell = batch_cell is not None
        has_keys = sample_keys is not None
        signature = (has_cell, has_keys)
        if signature not in self._callback_fns:
            # Differentiated path: one engine call computing energy+forces
            # together (the reference's precompute_gradient=True). The
            # non-differentiated primal path uses the energy-only host call.
            def host_args(p, *aux):
                aux = list(aux)
                return {'cell': aux.pop(0) if has_cell else None,
                        'sample_keys': aux.pop(0) if has_keys else None}

            self._callback_fns[signature] = make_callback_potential(
                lambda p, *aux: self.compute_energies_and_forces(
                    p, **host_args(p, *aux)),
                energy_fn=lambda p, *aux: self.compute_energies(
                    p, **host_args(p, *aux)),
                n_aux=has_cell + has_keys)
        fn = self._callback_fns[signature]
        aux = [a for a in (batch_cell, sample_keys) if a is not None]
        return fn(batch_positions, *aux)

    #: Finite-difference step for force-matching vector-Hessian products.
    fd_step: float = 1e-4

    def forces(self, batch_positions, batch_cell=None):
        """Differentiable per-sample forces (energy_unit/positions_unit).

        Differentiating through this (e.g. a force-matching loss) computes
        vector-Hessian products by finite differences of the engine forces —
        see :func:`tfep_tpu_torch.potentials.bridge.make_callback_forces`.
        """
        from tfep_tpu_torch.potentials.bridge import make_callback_forces

        has_cell = batch_cell is not None
        key = ('forces', has_cell)
        if key not in self._callback_fns:
            if has_cell:
                self._callback_fns[key] = make_callback_forces(
                    lambda p, c: self.compute_energies_and_forces(p, c),
                    has_cell=True, fd_step=self.fd_step)
            else:
                self._callback_fns[key] = make_callback_forces(
                    lambda p: self.compute_energies_and_forces(p),
                    has_cell=False, fd_step=self.fd_step)
        fn = self._callback_fns[key]
        if has_cell:
            return fn(batch_positions, batch_cell)
        return fn(batch_positions)

