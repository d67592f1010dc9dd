"""Sum-of-squares polynomial transformer (Jaini et al. 2019).

Port of ``tfep_tpu/nn/transformers/sos.py``:
``y_i = a_0 + int_0^{x_i} sum_k (a_k0 + a_k1 z)^2 dz``, monotone for any
parameters. Only degree-1 inner polynomials are supported: the map is a
monotone cubic, inverted in closed form (Cardano) with a Newton polish. A
plain differentiable expression; autograd gives the gradients.
"""

from __future__ import annotations

import numpy as np
import torch

from tfep_tpu_torch.nn.transformers.transformer import MAFTransformer

__all__ = ['SOSPolynomialTransformer', 'sos_polynomial_transformer',
           'sos_polynomial_transformer_inverse']


class SOSPolynomialTransformer(MAFTransformer):
    """SOS polynomial transformer with K squared first-degree polynomials.

    Each feature is mapped by ``y = a_0 + int_0^x sum_k (a_k0 + a_k1 z)^2
    dz``. Consumes ``1 + 2 * n_polynomials`` parameters per feature,
    ordered ``a_0, a_10, a_11, ..., a_K0, a_K1``. Stateless (it holds no
    tensor, so it takes no device). :meth:`inverse` is analytic.

    Parameters
    ----------
    n_polynomials : int, optional
        Number K >= 2 of squared degree-1 polynomials summed (default 2).
    """

    def __init__(self, n_polynomials: int = 2):
        super().__init__()
        if n_polynomials < 2:
            raise ValueError('n_polynomials must be strictly greater than 1.')
        self.n_polynomials = int(n_polynomials)

    @property
    def degree_polynomials(self) -> int:
        return 1

    @property
    def parameters_per_polynomial(self) -> int:
        return self.degree_polynomials + 1

    @property
    def n_parameters_per_feature(self) -> int:
        return self.parameters_per_polynomial * self.n_polynomials + 1

    def _reshape(self, parameters):
        return parameters.reshape(parameters.shape[0],
                                  self.n_parameters_per_feature, -1)

    def forward(self, x, parameters):
        return sos_polynomial_transformer(x, self._reshape(parameters))

    def inverse(self, y, parameters):
        """Analytic inverse: the map is a monotone cubic with one real root
        (:func:`sos_polynomial_transformer_inverse`)."""
        return sos_polynomial_transformer_inverse(y, self._reshape(parameters))

    def get_identity_parameters(self, n_features: int) -> np.ndarray:
        params = np.zeros((self.n_parameters_per_feature, n_features))
        # Identity: the squared constant terms sum to 1, linear terms 0.
        params[1::self.parameters_per_polynomial] = np.sqrt(
            1.0 / self.n_polynomials)
        return params.reshape(-1)

    def get_degrees_out(self, degrees_in: np.ndarray) -> np.ndarray:
        return np.tile(np.asarray(degrees_in), self.n_parameters_per_feature)

    def slice_features(self, feature_indices) -> 'SOSPolynomialTransformer':
        """Feature-subset view (stateless: the transformer itself)."""
        return self


def _sos_coefficients(parameters):
    """``a0, c1, c2, c3`` of ``y = a0 + c1 x + c2 x^2 + c3 x^3`` from the
    packed (batch, 1 + 2*K, n_features) parameters (interleaved
    ``a_k0``/``a_k1``)."""
    a0 = parameters[:, 0]
    zeroth = parameters[:, 1::2]   # (batch, K, n_features)
    first = parameters[:, 2::2]
    c1 = torch.sum(zeroth ** 2, dim=1)
    c2 = torch.sum(zeroth * first, dim=1)
    c3 = torch.sum(first ** 2, dim=1) / 3.0
    return a0, c1, c2, c3


def sos_polynomial_transformer(x, parameters):
    """Functional SOS transformer.

    Parameters
    ----------
    x : torch.Tensor, shape (batch, n_features)
    parameters : torch.Tensor, shape (batch, 1 + 2*K, n_features)
        Coefficients ordered ``a_0, a_10, a_11, ..., a_K0, a_K1``.

    Returns
    -------
    y : torch.Tensor, shape (batch, n_features)
        ``a_0 + c_1 x + c_2 x^2 + c_3 x^3``, monotone increasing in ``x``.
    log_det_J : torch.Tensor, shape (batch,)
        ``sum_i log dy_i/dx_i``.
    """
    a0, c1, c2, c3 = _sos_coefficients(parameters)
    y = a0 + x * (c1 + x * (c2 + x * c3))
    # dy/dx = c1 + 2 c2 x + 3 c3 x^2 = sum_k (a_k0 + a_k1 x)^2 >= 0.
    grad_x = c1 + 2 * c2 * x + 3 * c3 * x ** 2
    return y, torch.sum(torch.log(grad_x), dim=1)


def _cbrt(v):
    """Real cube root (torch has no ``cbrt``)."""
    return torch.sign(v) * torch.abs(v) ** (1.0 / 3.0)


def sos_polynomial_transformer_inverse(y, parameters):
    """Invert the degree-1 SOS transformer analytically.

    The forward map is the monotone cubic ``y = a0 + c1 x + c2 x^2 +
    c3 x^3``, so exactly one real root exists: Cardano's formula on the
    depressed cubic, then three Newton steps that repair its conditioning
    near triple roots and for small ``c3``. Where ``c3`` is negligible
    against the other coefficients the map is (nearly) affine and is
    inverted directly. Returns ``(x, log_det_J)`` with ``log_det_J =
    -sum log dy/dx`` at the recovered ``x``.
    """
    a0, c1, c2, c3 = _sos_coefficients(parameters)

    d = a0 - y                      # c3 x^3 + c2 x^2 + c1 x + d = 0
    eps = torch.finfo(y.dtype).eps
    # Cardano's intermediates involve (c2/c3)^6 and (d/c3)^2, which
    # overflow for a small nonzero c3. By Cauchy-Schwarz c2^2 <= 3 c1 c3,
    # so below this threshold the quadratic term is negligible too and the
    # linear start is within sqrt(eps), which the Newton polish squares.
    is_cubic = c3 > eps * (c1 + torch.abs(c2) + torch.abs(d))

    x_linear = -d / torch.clamp(c1, min=eps)

    # Cardano on the monic cubic x^3 + b x^2 + c x + e = 0.
    safe_c3 = torch.where(is_cubic, c3, 1.0)
    b = c2 / safe_c3
    c = c1 / safe_c3
    e = d / safe_c3
    shift = b / 3.0
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + e
    # One real root, so the discriminant is >= 0 (clamped against
    # round-off).
    disc = torch.clamp((q / 2.0) ** 2 + (p / 3.0) ** 3, min=0.0)
    s = torch.sqrt(disc)
    t = _cbrt(-q / 2.0 + s) + _cbrt(-q / 2.0 - s)
    x = torch.where(is_cubic, t - shift, x_linear)

    for _ in range(3):
        f = a0 + x * (c1 + x * (c2 + x * c3)) - y
        fp = c1 + 2.0 * c2 * x + 3.0 * c3 * x ** 2
        x = x - f / torch.clamp(fp, min=eps)

    grad_x = c1 + 2.0 * c2 * x + 3.0 * c3 * x ** 2
    return x, -torch.sum(torch.log(grad_x), dim=1)
