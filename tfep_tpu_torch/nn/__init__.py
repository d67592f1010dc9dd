"""Neural-network layer of the port: flows, transformers, conditioners,
the CNF's dynamics, embeddings and ODE solvers."""

from tfep_tpu_torch.nn.masked import MaskedLinear, create_autoregressive_mask  # noqa: F401
from tfep_tpu_torch.nn.flows import (  # noqa: F401
    AutoregressiveFlow, ContinuousFlow, Flow, MAF, SequentialFlow,
)
from tfep_tpu_torch.nn.dynamics import EGNNDynamics, MaskedVelocityDynamics  # noqa: F401
from tfep_tpu_torch.nn.embeddings import (  # noqa: F401
    BehlerParrinelloRadialExpansion, GaussianBasisExpansion,
)
from tfep_tpu_torch.nn.transformers import (  # noqa: F401
    AffineTransformer, MAFTransformer, NeuralSplineTransformer, Transformer,
    VolumePreservingShiftTransformer, affine_transformer,
    affine_transformer_inverse, neural_spline_transformer,
    neural_spline_transformer_inverse, volume_preserving_shift_transformer,
    volume_preserving_shift_transformer_inverse,
)
from tfep_tpu_torch.nn.conditioners import MADE, Conditioner, generate_degrees  # noqa: F401
