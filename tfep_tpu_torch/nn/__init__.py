"""Neural-network layer of the port: flows, transformers, conditioners,
the CNF's dynamics, embeddings, graph primitives and ODE solvers."""

from tfep_tpu_torch.nn.masked import MaskedLinear, create_autoregressive_mask  # noqa: F401
from tfep_tpu_torch.nn.flows import (  # noqa: F401
    AutoregressiveFlow, CartesianToMixedFlow, CenteredCentroidFlow,
    ContinuousFlow, Flow, MAF, OrientedFlow, PartialFlow, PCAWhitenedFlow,
    SequentialFlow,
)
from tfep_tpu_torch.nn.dynamics import EGNNDynamics, MaskedVelocityDynamics  # noqa: F401
from tfep_tpu_torch.nn.embeddings import (  # noqa: F401
    BehlerParrinelloRadialExpansion, FlipInvariantEmbedding,
    GaussianBasisExpansion, MAFEmbedding, MixedEmbedding, PeriodicEmbedding,
)
from tfep_tpu_torch.nn.transformers import (  # noqa: F401
    AffineTransformer, MAFTransformer, MixedTransformer, MoebiusTransformer,
    NeuralSplineTransformer, QuaternionProductTransformer,
    SOSPolynomialTransformer, SymmetrizedMoebiusTransformer, Transformer,
    VolumePreservingShiftTransformer, affine_transformer,
    affine_transformer_inverse, moebius_transformer,
    neural_spline_transformer, neural_spline_transformer_inverse,
    sos_polynomial_transformer, sos_polynomial_transformer_inverse,
    symmetrized_moebius_transformer,
    symmetrized_moebius_transformer_inverse,
    volume_preserving_shift_transformer,
    volume_preserving_shift_transformer_inverse,
)
from tfep_tpu_torch.nn.conditioners import MADE, Conditioner, generate_degrees  # noqa: F401
from tfep_tpu_torch.nn import ensemble  # noqa: F401
from tfep_tpu_torch.nn.ensemble import (  # noqa: F401
    ensemble_init, ensemble_map, make_ensemble_train_step, n_members,
    stack_modules, unstack_module,
)
