"""Transformers of the port."""

from tfep_tpu_torch.nn.transformers.transformer import Transformer, MAFTransformer  # noqa: F401
from tfep_tpu_torch.nn.transformers.affine import (  # noqa: F401
    AffineTransformer, VolumePreservingShiftTransformer,
    affine_transformer, affine_transformer_inverse,
    volume_preserving_shift_transformer,
    volume_preserving_shift_transformer_inverse,
)
from tfep_tpu_torch.nn.transformers.spline import (  # noqa: F401
    NeuralSplineTransformer, neural_spline_transformer,
    neural_spline_transformer_inverse,
)
from tfep_tpu_torch.nn.transformers.sos import (  # noqa: F401
    SOSPolynomialTransformer, sos_polynomial_transformer,
    sos_polynomial_transformer_inverse,
)
from tfep_tpu_torch.nn.transformers.moebius import (  # noqa: F401
    MoebiusTransformer, SymmetrizedMoebiusTransformer,
    moebius_transformer, symmetrized_moebius_transformer,
    symmetrized_moebius_transformer_inverse,
)
from tfep_tpu_torch.nn.transformers.quatprod import QuaternionProductTransformer  # noqa: F401
from tfep_tpu_torch.nn.transformers.mixed import MixedTransformer  # noqa: F401
