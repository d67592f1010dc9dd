"""PyTorch port of ``tfep_tpu`` for NVIDIA Hopper cards.

The layout mirrors ``tfep_tpu`` module by module, so each class has its
counterpart at the same relative path. Plain tensor code is PyTorch; the
Pallas kernels of the JAX package become hand-written kernels for Hopper in
``tfep_tpu_torch.ops``: Triton for the spline, CUDA C++ (``csrc/``) for the
EGNN pairwise block. This package imports neither JAX nor ``tfep_tpu``.

Entry points put their tensors on ``cuda`` unless the caller passes
``device='cpu'``; without a card and without ``device`` they raise.
"""

from tfep_tpu_torch import (  # noqa: F401
    analysis, app, io, nn, ops, parallel, potentials, units, utils,
)
from tfep_tpu_torch.device import resolve_device  # noqa: F401
from tfep_tpu_torch.loss import boltzmann_kl_div_loss, BoltzmannKLDivLoss  # noqa: F401
