"""Minimal unit system (host-side; tensors on the device are unitless).

A copy of ``tfep_tpu/units.py``: the port keeps its own, because importing
the JAX package's module would import JAX.

The reference framework uses ``pint`` for unit discipline at the engine
boundary (cf. upstream tfep/potentials/base.py:27-110 and the kT
computation at upstream tfep/app/base.py:208-213). pint is not
a dependency, so this module provides a small, dependency-free
dimensional-analysis layer with the subset of behavior the framework needs:

- quantities = magnitude (scalar or numpy array) x unit;
- unit algebra (multiply/divide/power) over base dimensions
  (mass, length, time, temperature, amount);
- ``Quantity.to(unit)`` conversion, with automatic molar conversion: converting
  a per-particle energy (e.g. hartree) to a per-mole energy (e.g. kcal/mol)
  multiplies by Avogadro's number and vice versa, mirroring the reference's
  fallback (cf. upstream tfep/utils/misc.py:203-208).

The device-side contract is unchanged from the reference: potentials and
log-weights are reduced to kT before entering the loss.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np

__all__ = [
    'Unit', 'Quantity', 'ureg', 'UnitRegistry',
]

# Base dimensions: (mass, length, time, temperature, amount)
_DIMLESS = (0, 0, 0, 0, 0)

# SI constants (CODATA 2018).
AVOGADRO = 6.02214076e23           # 1/mol
BOLTZMANN_SI = 1.380649e-23        # J/K
MOLAR_GAS_SI = AVOGADRO * BOLTZMANN_SI  # J/(mol K)

_HARTREE_J = 4.3597447222071e-18   # J
_BOHR_M = 5.29177210903e-11        # m
_EV_J = 1.602176634e-19            # J
_CAL_J = 4.184                     # J (thermochemical calorie)


class Unit:
    """A physical unit: an SI scale factor plus a tuple of dimension exponents.

    Units form an algebra: ``unit * unit``, ``unit / unit`` and ``unit ** n``
    combine scales and dimension exponents; ``number * unit`` (or
    ``array * unit``) builds a :class:`Quantity`, exactly like pint.

    Parameters
    ----------
    scale : float
        Conversion factor to the coherent SI unit of the same dimensions
        (e.g. ``1e-10`` for angstrom, whose SI unit is the meter).
    dims : tuple of int
        Exponents over the base dimensions
        ``(mass, length, time, temperature, amount)``.
    name : str, optional
        Display name used by ``repr``.

    Examples
    --------
    >>> round((2.0 * ureg.angstrom).to(ureg.nanometer).magnitude, 12)
    0.2
    """

    __slots__ = ('scale', 'dims', 'name')

    # Make numpy defer to __rmul__/__rtruediv__ for ``ndarray * unit`` (the
    # standard pint idiom) instead of broadcasting the Unit over elements
    # into an object array of per-element Quantities.
    __array_ufunc__ = None

    def __init__(self, scale: float, dims: tuple, name: str = ''):
        self.scale = float(scale)
        self.dims = tuple(dims)
        self.name = name

    # -- algebra ---------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Unit):
            dims = tuple(a + b for a, b in zip(self.dims, other.dims))
            return Unit(self.scale * other.scale, dims,
                        f'{self.name}*{other.name}')
        return Quantity(other, self)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Unit):
            dims = tuple(a - b for a, b in zip(self.dims, other.dims))
            return Unit(self.scale / other.scale, dims,
                        f'{self.name}/{other.name}')
        return NotImplemented

    def __rtruediv__(self, other):
        if isinstance(other, (int, float)):
            dims = tuple(-d for d in self.dims)
            return Unit(other / self.scale, dims, f'1/{self.name}')
        if isinstance(other, np.ndarray):
            # array / unit -> array-valued Quantity with the inverse unit
            # (the pint idiom, symmetric with array * unit).
            return Quantity(other, 1.0 / self)
        return NotImplemented

    def __pow__(self, exp):
        dims = tuple(d * exp for d in self.dims)
        return Unit(self.scale ** exp, dims, f'{self.name}**{exp}')

    def __eq__(self, other):
        return (isinstance(other, Unit) and self.dims == other.dims
                and math.isclose(self.scale, other.scale, rel_tol=1e-12))

    def __hash__(self):
        return hash((round(math.log(self.scale), 9) if self.scale > 0 else 0,
                     self.dims))

    def __repr__(self):
        return f'Unit({self.name or self.dims})'

    @property
    def is_dimensionless(self):
        """Whether this unit has no physical dimension."""
        return self.dims == _DIMLESS


class Quantity:
    """Magnitude (scalar or numpy array) with a unit.

    Supports the pint subset the framework uses: arithmetic that tracks
    dimensions, :meth:`to`/:meth:`m_as` conversion (including the automatic
    per-particle <-> per-mole conversion via Avogadro's number), and
    ``np.asarray(quantity)`` to strip units.

    Parameters
    ----------
    magnitude : float or numpy.ndarray
        The numeric value(s).
    units : Unit
        The unit the magnitude is expressed in.
    """

    __slots__ = ('magnitude', 'units')

    # ``ndarray * quantity`` must route through __rmul__ (keeping the unit),
    # not through __array__ (which would silently drop it).
    __array_ufunc__ = None

    def __init__(self, magnitude, units: Unit):
        self.magnitude = magnitude
        self.units = units

    # -- conversion ------------------------------------------------------
    def to(self, unit: Unit) -> 'Quantity':
        """Convert to ``unit`` (same dimensions, or the automatic
        per-particle <-> per-mole conversion); raises ``ValueError`` on
        any other dimension mismatch."""
        if self.units.dims == unit.dims:
            factor = self.units.scale / unit.scale
            return Quantity(self.magnitude * factor, unit)
        # Automatic molar conversion (per-particle <-> per-mole), mirroring
        # the reference's avogadro fallback in misc.py:203-208.
        amount_diff = self.units.dims[4] - unit.dims[4]
        if abs(amount_diff) == 1 and all(
                a == b for i, (a, b) in enumerate(zip(self.units.dims, unit.dims))
                if i != 4):
            if amount_diff == 1:
                # per-particle -> per-mole (e.g. hartree -> kJ/mol): x N_A.
                converted = self.magnitude * self.units.scale / unit.scale * AVOGADRO
            else:
                # per-mole -> per-particle: / N_A.
                converted = self.magnitude * self.units.scale / unit.scale / AVOGADRO
            return Quantity(converted, unit)
        raise ValueError(
            f'Cannot convert units with dims {self.units.dims} to {unit.dims}')

    def m_as(self, unit: Unit):
        """Magnitude expressed in ``unit``."""
        return self.to(unit).magnitude

    # -- arithmetic ------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Unit):
            return Quantity(self.magnitude, self.units * other)
        if isinstance(other, Quantity):
            return Quantity(self.magnitude * other.magnitude,
                            self.units * other.units)
        return Quantity(self.magnitude * other, self.units)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Quantity(self.magnitude, self.units / other)
        if isinstance(other, Quantity):
            return Quantity(self.magnitude / other.magnitude,
                            self.units / other.units)
        return Quantity(self.magnitude / other, self.units)

    def __rtruediv__(self, other):
        # scalar-or-array / quantity -> inverse-unit Quantity.
        return Quantity(other / self.magnitude, 1.0 / self.units)

    def __add__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.magnitude + other.to(self.units).magnitude,
                            self.units)
        raise TypeError('Can only add Quantity to Quantity.')

    def __sub__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.magnitude - other.to(self.units).magnitude,
                            self.units)
        raise TypeError('Can only subtract Quantity from Quantity.')

    def __neg__(self):
        return Quantity(-self.magnitude, self.units)

    def __array__(self, dtype=None):
        return np.asarray(self.magnitude, dtype=dtype)

    def __float__(self):
        return float(self.magnitude)

    def __repr__(self):
        return f'Quantity({self.magnitude!r}, {self.units!r})'

    def __eq__(self, other):
        if isinstance(other, Quantity):
            try:
                return bool(np.all(self.magnitude == other.to(self.units).magnitude))
            except ValueError:
                return False
        return NotImplemented


class UnitRegistry:
    """Registry of common molecular-simulation units (pint-like namespace).

    Exposes every unit the framework's engine boundary needs as an
    attribute (``ureg.angstrom``, ``ureg.kilojoule_per_mole``, ...) plus
    pint-compatible plural/abbreviated aliases, physical constants as
    quantities, limited string lookup (:meth:`parse_units`), and the
    temperature -> thermal-energy helper (:meth:`kT`) that the app layer
    uses to reduce potentials (reference kT computation:
    upstream tfep/app/base.py:208-213).
    """

    def __init__(self):
        # Base units.
        self.kilogram = Unit(1.0, (1, 0, 0, 0, 0), 'kilogram')
        self.meter = Unit(1.0, (0, 1, 0, 0, 0), 'meter')
        self.second = Unit(1.0, (0, 0, 1, 0, 0), 'second')
        self.kelvin = Unit(1.0, (0, 0, 0, 1, 0), 'kelvin')
        self.mole = Unit(1.0, (0, 0, 0, 0, 1), 'mole')
        self.dimensionless = Unit(1.0, _DIMLESS, '')

        # Lengths.
        self.angstrom = Unit(1e-10, self.meter.dims, 'angstrom')
        self.nanometer = Unit(1e-9, self.meter.dims, 'nanometer')
        self.picometer = Unit(1e-12, self.meter.dims, 'picometer')
        self.bohr = Unit(_BOHR_M, self.meter.dims, 'bohr')
        self.centimeter = Unit(1e-2, self.meter.dims, 'centimeter')

        # Times.
        self.femtosecond = Unit(1e-15, self.second.dims, 'femtosecond')
        self.picosecond = Unit(1e-12, self.second.dims, 'picosecond')
        self.nanosecond = Unit(1e-9, self.second.dims, 'nanosecond')

        # Energies (per particle).
        energy_dims = (1, 2, -2, 0, 0)
        self.joule = Unit(1.0, energy_dims, 'joule')
        self.hartree = Unit(_HARTREE_J, energy_dims, 'hartree')
        self.eV = Unit(_EV_J, energy_dims, 'eV')
        self.calorie = Unit(_CAL_J, energy_dims, 'calorie')

        # Energies per mole.
        molar_energy_dims = (1, 2, -2, 0, -1)
        self.joule_per_mole = Unit(1.0, molar_energy_dims, 'joule/mole')
        self.kilojoule_per_mole = Unit(1e3, molar_energy_dims, 'kJ/mole')
        self.kilocalorie_per_mole = Unit(
            1e3 * _CAL_J, molar_energy_dims, 'kcal/mole')

        # Masses.
        self.gram = Unit(1e-3, self.kilogram.dims, 'gram')
        self.dalton = Unit(1e-3 / AVOGADRO, self.kilogram.dims, 'dalton')

        # Aliases (pint-compatible spellings used across the codebase).
        self.kilojoule = Unit(1e3, energy_dims, 'kilojoule')
        self.kilocalorie = Unit(1e3 * _CAL_J, energy_dims, 'kilocalorie')
        self.kJ = self.kilojoule
        self.kcal = self.kilocalorie
        self.cal = self.calorie
        self.kJ_mol = self.kilojoule_per_mole
        self.kcal_mol = self.kilocalorie_per_mole
        self.mol = self.mole
        # Pint accepts plural spellings; mirror the common ones.
        self.seconds = self.second
        self.picoseconds = self.picosecond
        self.femtoseconds = self.femtosecond
        self.nanoseconds = self.nanosecond
        self.angstroms = self.angstrom
        self.nanometers = self.nanometer
        self.nm = self.nanometer
        self.ps = self.picosecond
        self.fs = self.femtosecond
        self.ns = self.nanosecond
        self.K = self.kelvin
        self.amu = self.dalton

        # Physical constants as quantities.
        self.avogadro_constant = Quantity(AVOGADRO, 1 / self.mole)
        self.boltzmann_constant = Quantity(
            BOLTZMANN_SI, self.joule / self.kelvin)
        self.molar_gas_constant = Quantity(
            MOLAR_GAS_SI, self.joule_per_mole / self.kelvin)

    def parse_units(self, name: str) -> Unit:
        """Resolve a unit by attribute name (limited pint-style lookup)."""
        normalized = name.replace(' ', '').replace('/', '_per_')
        if hasattr(self, normalized):
            return getattr(self, normalized)
        raise ValueError(f'Unknown unit: {name!r}')

    def kT(self, temperature: 'Quantity', energy_unit: Unit = None) -> 'Quantity':
        """Thermal energy kB*T (per particle or per mole based on energy_unit).

        Mirrors the reference's kT computation (app/base.py:208-213): per-mole
        energy units use the molar gas constant R, per-particle units use kB.
        """
        if energy_unit is None:
            energy_unit = self.kilojoule_per_mole
        t_kelvin = temperature.to(self.kelvin).magnitude
        if energy_unit.dims[4] == -1:  # per-mole energy
            kt = Quantity(MOLAR_GAS_SI * t_kelvin, self.joule_per_mole)
        else:
            kt = Quantity(BOLTZMANN_SI * t_kelvin, self.joule)
        return kt.to(energy_unit)


#: Global default registry (like ``pint``'s application registry).
ureg = UnitRegistry()
