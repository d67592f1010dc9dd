"""Data and persistence: datasets, stateful sampler, TFEP logger.

The port of ``tfep_tpu/io``'s in-memory part. The trajectory and topology
file formats are not ported yet.
"""

from tfep_tpu_torch.io.dataset import (  # noqa: F401
    Dataset, DictDataset, MergedDataset, Subset, TrajectorySubset,
)
from tfep_tpu_torch.io.sampler import StatefulBatchSampler  # noqa: F401
from tfep_tpu_torch.io.log import TFEPLogger  # noqa: F401
from tfep_tpu_torch.io.traj import (  # noqa: F401
    System, Timestep, TrajectoryDataset, get_subsampled_indices,
)
