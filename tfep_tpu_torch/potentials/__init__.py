"""Potential-energy backends (the engine boundary).

Port of ``tfep_tpu/potentials``. Potentials written in torch run inside
the training step directly; external engines go through the autograd
Functions of :mod:`tfep_tpu_torch.potentials.bridge`. Engine backends
(ase/openmm/psi4/tblite) require their packages installed and import them
only when used; gromacs/mimic need the CLI executables. No module here
touches CUDA when it is imported, so a spawned worker of a process pool
can import the task functions.
"""

from tfep_tpu_torch.potentials.base import PotentialBase  # noqa: F401
from tfep_tpu_torch.potentials.engine import EnginePotential  # noqa: F401
from tfep_tpu_torch.potentials.bridge import (  # noqa: F401
    make_callback_potential,
)
from tfep_tpu_torch.potentials import (  # noqa: F401
    ase, openmm, psi4, tblite, gromacs, mimic,
)
from tfep_tpu_torch.potentials.ase import (  # noqa: F401
    ASEPotential, ase_potential_energy,
)
from tfep_tpu_torch.potentials.openmm import (  # noqa: F401
    OpenMMPotential, openmm_potential_energy,
)
from tfep_tpu_torch.potentials.psi4 import (  # noqa: F401
    Psi4Potential, psi4_potential_energy,
)
from tfep_tpu_torch.potentials.tblite import (  # noqa: F401
    TBLitePotential, tblite_potential_energy,
)
from tfep_tpu_torch.potentials.gromacs import (  # noqa: F401
    GROMACSPotential, gromacs_potential_energy,
)
from tfep_tpu_torch.potentials.mimic import (  # noqa: F401
    MiMiCPotential, mimic_potential_energy,
)
