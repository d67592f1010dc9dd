"""Flows of the port."""

from tfep_tpu_torch.nn.flows.flow import Flow  # noqa: F401
from tfep_tpu_torch.nn.flows.autoregressive import AutoregressiveFlow  # noqa: F401
from tfep_tpu_torch.nn.flows.continuous import ContinuousFlow  # noqa: F401
from tfep_tpu_torch.nn.flows.maf import MAF  # noqa: F401
from tfep_tpu_torch.nn.flows.sequential import SequentialFlow  # noqa: F401
