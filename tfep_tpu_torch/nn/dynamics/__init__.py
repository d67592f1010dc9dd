"""Velocity fields for continuous flows."""

from tfep_tpu_torch.nn.dynamics.egnn import EGNNDynamics  # noqa: F401
from tfep_tpu_torch.nn.dynamics.masked import MaskedVelocityDynamics, dynamics_jvp  # noqa: F401
