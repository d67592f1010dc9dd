"""Target potentials the configurations train towards."""

from __future__ import annotations

import torch


class HarmonicPotential:
    """``0.5 kT |y|^2`` in kcal/mol at ``temperature_K``: reduced by kT,
    ``0.5 |y|^2``."""

    def __init__(self, temperature_K):
        from tfep_tpu_torch.units import ureg
        self.energy_unit = ureg.kilocalorie_per_mole
        self.kT = float(ureg.kT(temperature_K * ureg.kelvin,
                                self.energy_unit).magnitude)

    def __call__(self, x, cell=None):
        return 0.5 * self.kT * torch.sum(x * x, dim=-1)
