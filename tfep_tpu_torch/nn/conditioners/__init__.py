"""Conditioners of the port."""

from tfep_tpu_torch.nn.conditioners.conditioner import Conditioner  # noqa: F401
from tfep_tpu_torch.nn.conditioners.made import MADE, generate_degrees  # noqa: F401
