"""Moebius and symmetrized-Moebius sphere transformers.

Port of ``tfep_tpu/nn/transformers/moebius.py``. Moebius transformations
expand and contract distributions on spheres (Kato & McCullagh; Rezende
et al., "Normalizing Flows on Tori and Spheres"), here on the sphere of
radius ``|x|``; the symmetrized variant (Köhler et al., "Rigid body
flows") is invertible in closed form with an analytic log-det. Parameter
vectors ``w`` of any norm are rescaled below ``max_radius * |x|``.
"""

from __future__ import annotations

import numpy as np
import torch

from tfep_tpu_torch.nn.transformers.transformer import MAFTransformer
from tfep_tpu_torch.utils.math import batchwise_dot, batchwise_outer

__all__ = [
    'MoebiusTransformer', 'SymmetrizedMoebiusTransformer',
    'moebius_transformer', 'symmetrized_moebius_transformer',
    'symmetrized_moebius_transformer_inverse',
]


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


class _VectorTransformer(MAFTransformer):
    """Features grouped into consecutive ``dimension``-vectors, one
    parameter vector per input vector. Stateless (it holds no tensor, so
    it takes no device)."""

    n_parameters_per_feature = 1

    def _apply(self, fn, x, parameters, **kwargs):
        batch_size, n_features = x.shape
        out, log_det_J = fn(x.reshape(batch_size, -1, self.dimension),
                            parameters.reshape(batch_size, -1,
                                               self.dimension), **kwargs)
        return out.reshape(batch_size, n_features), log_det_J

    def get_degrees_out(self, degrees_in: np.ndarray) -> np.ndarray:
        return np.asarray(degrees_in).copy()


class MoebiusTransformer(_VectorTransformer):
    """Moebius transformer on spheres of radius ``|x|`` (vector-wise).

    Each vector keeps its norm, so the transformer suits unit vectors such
    as bond directions. ``w`` is rescaled to ``max_radius * |x|`` to keep
    the map invertible, and the inverse is the same transform with ``-w``.

    Parameters
    ----------
    dimension : int, optional
        Vector size (default 3).
    max_radius : float, optional
        Upper bound on ``|w| / |x|`` (default 0.99).
    unit_sphere : bool, optional
        Assume unit-norm inputs (skips the radial factor).
    """

    def __init__(self, dimension: int = 3, max_radius: float = 0.99,
                 unit_sphere: bool = False):
        super().__init__()
        self.dimension = int(dimension)
        self.max_radius = float(max_radius)
        self.unit_sphere = bool(unit_sphere)

    def forward(self, x, parameters):
        return self._apply(moebius_transformer, x, parameters,
                           max_radius=self.max_radius,
                           unit_sphere=self.unit_sphere)

    def inverse(self, y, parameters):
        """The transform with ``-w``."""
        return self._apply(moebius_transformer, y, -parameters,
                           max_radius=self.max_radius,
                           unit_sphere=self.unit_sphere)

    def get_identity_parameters(self, n_features: int) -> np.ndarray:
        return np.zeros(n_features)


class SymmetrizedMoebiusTransformer(_VectorTransformer):
    """Symmetrized Moebius transformer (closed-form inverse, analytic
    log-det), the Moebius transform symmetrized over ``+w``/``-w``.

    Parameters
    ----------
    dimension : int, optional
        Size of each transformed vector (default 3).
    max_radius : float, optional
        Invertibility margin (default 0.99).
    identity_eps, identity_seed : float, int, optional
        Scale and seed of the near-zero random identity parameters: at
        ``w = 0`` the parameter gradient vanishes and training stalls.
    """

    def __init__(self, dimension: int = 3, max_radius: float = 0.99,
                 identity_eps: float = 1e-9, identity_seed: int = 0):
        super().__init__()
        self.dimension = int(dimension)
        self.max_radius = float(max_radius)
        self.identity_eps = float(identity_eps)
        self.identity_seed = int(identity_seed)

    def forward(self, x, parameters):
        return self._apply(symmetrized_moebius_transformer, x, parameters,
                           max_radius=self.max_radius)

    def inverse(self, y, parameters):
        return self._apply(symmetrized_moebius_transformer_inverse, y,
                           parameters, max_radius=self.max_radius)

    def get_identity_parameters(self, n_features: int) -> np.ndarray:
        rng = np.random.default_rng(self.identity_seed)
        return (2 * rng.random(n_features) - 1) * self.identity_eps


# =============================================================================
# Functional API
# =============================================================================

def moebius_transformer(x, w, max_radius: float = 0.99,
                        unit_sphere: bool = False,
                        return_log_det_J: bool = True):
    """``y = (|x|^2 - |w|^2) / |x - w|^2 * (x - w) - w`` with ``|w| < |x|``.

    Parameters
    ----------
    x : torch.Tensor, shape (batch, n_vectors, dimension)
        Input vectors, each transformed on the sphere of its own norm.
    w : torch.Tensor, shape (batch, n_vectors, dimension)
        Raw parameter vectors, rescaled to ``max_radius * |x|``.
    max_radius : float, optional
    unit_sphere : bool, optional
        Assume ``|x| = 1`` (skips the radial projection factor).
    return_log_det_J : bool, optional
        If ``False``, return only ``y``.

    Returns
    -------
    y : torch.Tensor, shape (batch, n_vectors, dimension)
    log_det_J : torch.Tensor, shape (batch,)
        From the slogdet of each vector's Jacobian block (if requested).
    """
    dimension = x.shape[-1]

    w_norm = _norm(w)
    rescaling = max_radius / (1 + w_norm)
    if not unit_sphere:
        x_norm = _norm(x)
        rescaling = x_norm * rescaling
    w = rescaling * w
    w_norm = rescaling * w_norm

    if unit_sphere:
        numerator = 1 - w_norm ** 2
    else:
        numerator = x_norm ** 2 - w_norm ** 2
    diff = x - w
    diff_norm = _norm(diff)
    y = numerator / diff_norm ** 2 * diff - w

    if not return_log_det_J:
        return y

    numerator_e = numerator[..., None]
    diff_norm_e = diff_norm[..., None]
    dd_outer = batchwise_outer(diff, diff)
    eye = torch.eye(dimension, dtype=x.dtype, device=x.device).expand(
        dd_outer.shape)
    jac = numerator_e * (eye / diff_norm_e ** 2
                         - 2 / diff_norm_e ** 4 * dd_outer)

    if not unit_sphere:
        x_norm_e = x_norm[..., None]
        jac2 = eye - batchwise_outer(x, x) / x_norm_e ** 2
        jac = batchwise_outer(y, x) / x_norm_e ** 2 + jac @ jac2

    return y, torch.linalg.slogdet(jac)[1].sum(dim=-1)


def symmetrized_moebius_transformer(x, w, max_radius: float = 0.99):
    """``y = |x| * (f(x;w) + f(x;-w)) / |f(x;w) + f(x;-w)|``.

    Shapes and rescaling as :func:`moebius_transformer`; returns
    ``(y, log_det_J)`` with the analytic spherical volume element.
    """
    f_sym = (moebius_transformer(x, w, max_radius, return_log_det_J=False)
             + moebius_transformer(x, -w, max_radius,
                                   return_log_det_J=False))
    x_norm = _norm(x)
    y = x_norm / _norm(f_sym) * f_sym

    w_norm = _norm(w)
    rescaling = max_radius / (1 + w_norm)
    log_det_J = _symmetrized_moebius_log_det_J(
        x / x_norm, rescaling * w, (rescaling * w_norm) ** 2)
    return y, log_det_J


def symmetrized_moebius_transformer_inverse(x, w, max_radius: float = 0.99):
    """Closed-form inverse (Köhler et al., arXiv:2301.11355).

    Solves for the pre-image in the plane spanned by ``w`` and the part of
    ``x`` orthogonal to it; shapes as
    :func:`symmetrized_moebius_transformer`. Returns ``(x, log_det_J)``
    with the negated volume element at the recovered point.
    """
    x_norm = _norm(x)
    x_unit = x / x_norm

    w_norm = _norm(w)
    rescaling = max_radius / (1 + w_norm)
    w_unit = rescaling * w
    w_unit_norm = rescaling * w_norm

    # The 2D frame spanned by (w, x - proj(x, w)).
    da = w_unit / w_unit_norm
    a = batchwise_dot(x_unit, da, keepdim=True)
    db = x_unit - a * da
    db = db / _norm(db)

    r2 = w_unit_norm ** 2
    a_inv = -a * (r2 + 1.0) / torch.sqrt(1 + r2 ** 2 + r2 * (4 * a ** 2 - 2))
    b_inv = -torch.sqrt(1 - a_inv ** 2)

    x_unit_inv = -(a_inv * da + b_inv * db)
    log_det_J = -_symmetrized_moebius_log_det_J(x_unit_inv, w_unit, r2)
    return x_norm * x_unit_inv, log_det_J


def _symmetrized_moebius_log_det_J(x, w, r2):
    """Analytic log-det on the unit sphere (Köhler et al.'s dV)."""
    dimension = x.shape[-1]
    qy2 = r2 - batchwise_dot(x, w, keepdim=True) ** 2
    numer = (1 - r2) * (1 + r2) ** (dimension - 1)
    denom = (4 * qy2 + (1 - r2) ** 2) ** (dimension / 2)
    return torch.log(numer / denom)[..., 0].sum(dim=1)
