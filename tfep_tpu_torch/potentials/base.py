"""Potential-energy backend base class (the engine boundary).

A copy of ``tfep_tpu/potentials/base.py``: the port keeps its own,
because importing the JAX package's module would import JAX.

A potential maps device batches of mapped coordinates to per-sample energies:
``potential(batch_positions, batch_cell=None) -> (batch,)``. Potentials
written in torch (test/analytic) run inside the training step; external
engines go through the :mod:`tfep_tpu_torch.potentials.bridge` autograd
Functions, whose backward is ``-forces * g`` — the same contract as the
reference's autograd Functions (upstream tfep/potentials/ase.py:291-320).
Unit discipline mirrors upstream tfep/potentials/base.py:27-110 using
:mod:`tfep_tpu_torch.units`.
"""

from __future__ import annotations

from typing import Optional

from tfep_tpu_torch.units import Unit, ureg

__all__ = ['PotentialBase']


class PotentialBase:
    """Base class for potential energy functions with unit bookkeeping.

    Subclasses declare their engine's native units via the
    ``DEFAULT_ENERGY_UNIT``/``DEFAULT_POSITIONS_UNIT`` class attributes
    (names resolved on the global :data:`~tfep_tpu_torch.units.ureg`) and
    implement ``__call__``. The app layer reads :attr:`energy_unit` to
    form kT, so device arrays themselves stay unitless (reference:
    upstream tfep/potentials/base.py:27-110).

    Parameters
    ----------
    positions_unit : Unit, optional
        Unit the (unitless) input position arrays are expressed in;
        ``None`` means the class default.
    energy_unit : Unit, optional
        Unit of the returned energies; ``None`` means the class default.
    """

    #: Name of the default energy unit (attribute of the unit registry).
    DEFAULT_ENERGY_UNIT: str = ''
    #: Name of the default positions unit (attribute of the unit registry).
    DEFAULT_POSITIONS_UNIT: str = ''

    def __init__(self, positions_unit: Optional[Unit] = None,
                 energy_unit: Optional[Unit] = None):
        """``positions_unit`` is the unit of the (unitless) input arrays;
        ``energy_unit`` that of the returned energies. ``None`` means the
        class defaults (no conversion)."""
        self._positions_unit = positions_unit
        self._energy_unit = energy_unit

    @property
    def positions_unit(self) -> Unit:
        if self._positions_unit is None:
            return getattr(ureg, self.DEFAULT_POSITIONS_UNIT)
        return self._positions_unit

    @property
    def energy_unit(self) -> Unit:
        if self._energy_unit is None:
            return getattr(ureg, self.DEFAULT_ENERGY_UNIT)
        return self._energy_unit

    @classmethod
    def default_positions_unit(cls) -> Unit:
        return getattr(ureg, cls.DEFAULT_POSITIONS_UNIT)

    @classmethod
    def default_energy_unit(cls) -> Unit:
        return getattr(ureg, cls.DEFAULT_ENERGY_UNIT)

    def __call__(self, batch_positions, batch_cell=None):
        """Return per-sample potential energies, shape ``(batch,)``."""
        raise NotImplementedError
