"""Data and persistence: datasets, stateful sampler, TFEP logger, and the
trajectory and topology file formats.

The port of ``tfep_tpu/io`` (numpy only, no JAX).
"""

from tfep_tpu_torch.io.dataset import (  # noqa: F401
    Dataset, DictDataset, MergedDataset, Subset, TrajectorySubset,
)
from tfep_tpu_torch.io.sampler import StatefulBatchSampler  # noqa: F401
from tfep_tpu_torch.io.log import TFEPLogger  # noqa: F401
from tfep_tpu_torch.io.traj import (  # noqa: F401
    System, Timestep, TrajectoryDataset, get_subsampled_indices,
)
from tfep_tpu_torch.io.topfiles import (  # noqa: F401
    guess_bonds, read_gromacs_top, read_prmtop, read_psf,
)
from tfep_tpu_torch.io.frames import open_frame_store  # noqa: F401
from tfep_tpu_torch.io.netcdf import (  # noqa: F401
    read_amber_netcdf_header, write_amber_netcdf,
)
from tfep_tpu_torch.io.restart import read_amber_restart  # noqa: F401
from tfep_tpu_torch.io.writers import (  # noqa: F401
    write_frames, write_gro, write_pdb, write_xyz,
)
