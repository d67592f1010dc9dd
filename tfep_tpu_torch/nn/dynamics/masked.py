"""Velocity masking: conditioning DOFs for continuous flows.

Port of ``tfep_tpu/nn/dynamics/masked.py``. The wrapped dynamics sees the
full state, but its velocities are zeroed on the conditioning DOFs, so
those coordinates are integrated in place; their Jacobian rows vanish, so
the exact trace and the Hutchinson estimates stay correct.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tfep_tpu_torch.device import resolve_device

__all__ = ['MaskedVelocityDynamics', 'dynamics_jvp']


def dynamics_jvp(dynamics, t, x, v):
    """``(f(t, x), J_x f(t, x) v)``: the dynamics' own dual pass
    ``forward_and_jvp`` where it has one (the fused EGNN path), else
    ``torch.func.jvp``."""
    if hasattr(dynamics, 'forward_and_jvp'):
        return dynamics.forward_and_jvp(t, x, v)
    return torch.func.jvp(lambda z: dynamics(t, z), (x,), (v,))


class MaskedVelocityDynamics(nn.Module):
    """Zero a dynamics' velocities on a fixed set of feature indices.

    Parameters
    ----------
    dynamics : nn.Module
        The wrapped velocity field ``v = f(t, x)``.
    velocity_mask : torch.Tensor
        ``(dim,)`` float mask: 1 on transported DOFs, 0 on conditioning
        DOFs. Build with :meth:`create` from the zeroed indices.
    """

    def __init__(self, dynamics, velocity_mask):
        super().__init__()
        self.dynamics = dynamics
        self.register_buffer('velocity_mask', velocity_mask)

    @classmethod
    def create(cls, dynamics, zero_velocity_indices, dim: int, device=None,
               dtype: torch.dtype = torch.float32
               ) -> 'MaskedVelocityDynamics':
        """Wrap ``dynamics`` so the ``zero_velocity_indices`` DOFs (over a
        ``dim``-feature flattened state) never move. ``device`` defaults
        to ``cuda`` and raises without a card."""
        mask = np.ones(dim)
        mask[np.asarray(zero_velocity_indices, dtype=np.int64)] = 0.0
        return cls(dynamics, torch.as_tensor(mask, dtype=dtype,
                                             device=resolve_device(device)))

    def forward(self, t, x):
        return self.dynamics(t, x) * self.velocity_mask.to(x.dtype)

    def forward_and_jvp(self, t, x, v):
        """``(f(t, x), J f v)``, both masked."""
        vel, jv = dynamics_jvp(self.dynamics, t, x, v)
        mask = self.velocity_mask.to(x.dtype)
        return vel * mask, jv * mask
