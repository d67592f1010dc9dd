"""Flows of the port."""

from tfep_tpu_torch.nn.flows.flow import Flow  # noqa: F401
from tfep_tpu_torch.nn.flows.autoregressive import AutoregressiveFlow  # noqa: F401
from tfep_tpu_torch.nn.flows.continuous import ContinuousFlow  # noqa: F401
from tfep_tpu_torch.nn.flows.maf import MAF  # noqa: F401
from tfep_tpu_torch.nn.flows.sequential import SequentialFlow  # noqa: F401
from tfep_tpu_torch.nn.flows.partial import PartialFlow  # noqa: F401
from tfep_tpu_torch.nn.flows.centroid import CenteredCentroidFlow  # noqa: F401
from tfep_tpu_torch.nn.flows.oriented import OrientedFlow  # noqa: F401
from tfep_tpu_torch.nn.flows.pca import PCAWhitenedFlow  # noqa: F401
from tfep_tpu_torch.nn.flows.cartmixed import CartesianToMixedFlow  # noqa: F401
