"""Post-hoc analysis: FEP estimator and device-vectorized bootstrap.

The port of ``tfep_tpu/analysis`` to torch tensors.
"""

from tfep_tpu_torch.analysis.estimator import (  # noqa: F401
    estimate_from_logger, fep_estimator,
)
from tfep_tpu_torch.analysis.bootstrap import bootstrap  # noqa: F401
