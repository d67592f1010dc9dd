"""App layer: trainer and TFEP maps.

Port of ``tfep_tpu/app``: every map of the JAX package.
"""

from tfep_tpu_torch.app.trainer import Trainer, load_map_from_checkpoint  # noqa: F401
from tfep_tpu_torch.app.base import TFEPMapBase  # noqa: F401
from tfep_tpu_torch.app.cartesianmaf import CartesianMAFMap  # noqa: F401
from tfep_tpu_torch.app.continuousegnn import ContinuousEGNNMap  # noqa: F401
from tfep_tpu_torch.app.mixedmaf import MixedMAFMap  # noqa: F401
