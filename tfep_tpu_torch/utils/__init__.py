"""Host and tensor utilities of the port: math, geometry, index helpers."""

from tfep_tpu_torch.utils import geometry, math, misc  # noqa: F401
