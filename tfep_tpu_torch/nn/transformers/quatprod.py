"""Quaternion-product transformer: volume-preserving rigid rotations.

Port of ``tfep_tpu/nn/transformers/quatprod.py``. Each input quaternion
(xyzw: vector part first, scalar last) is multiplied by a normalized
parameter quaternion; the inverse multiplies by its conjugate. Unit
Jacobian.
"""

from __future__ import annotations

import numpy as np
import torch

from tfep_tpu_torch.nn.transformers.transformer import MAFTransformer

__all__ = ['QuaternionProductTransformer', 'quat_product', 'quat_normalize',
           'quat_conjugate']


def quat_normalize(q):
    """Normalize quaternions along the last axis."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_conjugate(q):
    """Conjugate in xyzw layout: negate the vector part."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_product(p, q):
    """Hamilton product ``p * q`` in xyzw layout (rotating by ``q``, then
    ``p``); ``p`` and ``q`` of shape (..., 4), broadcastable."""
    pv, pw = p[..., :3], p[..., 3:]
    qv, qw = q[..., :3], q[..., 3:]
    pv, qv = torch.broadcast_tensors(pv, qv)
    vector = pw * qv + qw * pv + torch.linalg.cross(pv, qv, dim=-1)
    scalar = pw * qw - torch.sum(pv * qv, dim=-1, keepdim=True)
    return torch.cat([vector, scalar], dim=-1)


class QuaternionProductTransformer(MAFTransformer):
    """Rotate each input quaternion by a normalized parameter quaternion.

    Features are grouped in fours (xyzw quaternions); each group is
    left-multiplied by the conditioner's quaternion after normalization.
    ``log_det_J`` is zero both ways, and the inverse multiplies by the
    conjugate. One parameter per feature. Stateless (it holds no tensor,
    so it takes no device).
    """

    n_parameters_per_feature = 1

    def forward(self, x, parameters):
        batch_size = x.shape[0]
        y = quat_product(quat_normalize(parameters.reshape(-1, 4)),
                         x.reshape(-1, 4))
        return (y.reshape(batch_size, -1),
                torch.zeros(batch_size, dtype=x.dtype, device=x.device))

    def inverse(self, y, parameters):
        batch_size = y.shape[0]
        x = quat_product(quat_conjugate(quat_normalize(
            parameters.reshape(-1, 4))), y.reshape(-1, 4))
        return (x.reshape(batch_size, -1),
                torch.zeros(batch_size, dtype=y.dtype, device=y.device))

    def get_identity_parameters(self, n_features: int) -> np.ndarray:
        """Identity quaternion (0, 0, 0, 1) per input quaternion."""
        if n_features % 4 != 0:
            raise ValueError('n_features must be divisible by 4.')
        params = np.zeros((n_features // 4, 4))
        params[:, 3] = 1.0
        return params.reshape(-1)

    def get_degrees_out(self, degrees_in: np.ndarray) -> np.ndarray:
        return np.asarray(degrees_in).copy()
