"""Rational-quadratic (neural) spline transformer, with circular variant.

Port of ``tfep_tpu/nn/transformers/spline.py``: Durkan et al.'s neural
spline flows with per-feature fixed domains ``x0/xf/y0/yf`` and linear
extrapolation outside, circular (periodic) splines with a learned phase
shift, identity boundary slopes, learnable lower/upper domain bounds, and
min bin-size/slope floors. The parameter-count contract
(``n_parameters_per_feature``) is the JAX package's, since MADE output
degrees depend on it.

In the standard configuration (non-circular, fixed domain, K+1 free
slopes), and in the distances' (identity boundary slopes and a learnable
upper bound) and the torsions' (circular, with or without identity
boundary slopes), the forward pass goes through
:func:`tfep_tpu_torch.ops.spline.fused_spline`: the Triton kernels K1/K2
on a CUDA tensor, their plain version on a CPU tensor. A learnable lower
bound, and identity slopes or a learnable upper bound alone, take the
one-hot formulation.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.nn.transformers.transformer import MAFTransformer
from tfep_tpu_torch.ops.spline import (
    KINDS, fused_spline, softplus, spline_offset,
)

__all__ = [
    'NeuralSplineTransformer',
    'neural_spline_transformer', 'neural_spline_transformer_inverse',
]

_FUSED_POLICIES = ('auto', 'always', 'never')


class NeuralSplineTransformer(MAFTransformer):
    """Neural spline transformer (optionally circular / learnable-domain).

    Parameters
    ----------
    x0, xf : array_like, shape (n_features,) or scalar
        Lower/upper input-domain bound of each feature's spline; inputs
        outside are mapped by linear extrapolation with the boundary slopes.
    n_bins : int
        Number of rational-quadratic bins K.
    y0, yf : array_like, optional
        Output-domain bounds; default to ``x0``/``xf``.
    circular : bool, optional
        Periodic spline (torsions): ties the boundary slopes and adds a
        learned phase shift. Requires ``y0 == x0`` and ``yf == xf``.
    identity_boundary_slopes : bool, optional
        Pin both boundary slopes to 1 (C1 continuity with the linear tails).
    learn_lower_bound, learn_upper_bound : bool, optional
        Make the domain bounds conditioner outputs (log-scale + shift).
        Incompatible with ``circular``.
    min_bin_size, min_slope : float, optional
        Positivity floors on bin sizes and knot slopes.
    fused : {'auto', 'always', 'never'}, optional
        In a configuration the kernels take (:attr:`_fused_kind`), 'auto'
        and 'always' run the fused spline (the Triton kernels on a CUDA
        tensor) and 'never' runs the one-hot formulation of
        :meth:`_forward_impl`. The JAX package's
        'auto' picks its XLA path because of a TPU measurement, which does
        not carry over to this card.
    remat : bool, optional
        Recompute the unfused path's intermediates in the backward pass
        (``torch.utils.checkpoint``) instead of saving them.
    device : str or torch.device, optional
        Defaults to ``cuda``; raises without a card.
    dtype : torch.dtype, optional
        Type of the domain bounds.
    """

    def __init__(self, x0, xf, n_bins: int, y0=None, yf=None,
                 circular: bool = False,
                 identity_boundary_slopes: bool = False,
                 learn_lower_bound: bool = False,
                 learn_upper_bound: bool = False,
                 min_bin_size: float = 1e-4,
                 min_slope: float = 1e-4,
                 fused: str = 'auto',
                 remat: bool = False,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        device = resolve_device(device)
        x0 = np.asarray(x0)
        xf = np.asarray(xf)
        y0 = x0 if y0 is None else np.asarray(y0)
        yf = xf if yf is None else np.asarray(yf)

        if circular and (learn_lower_bound or learn_upper_bound):
            raise ValueError(
                'Cannot instantiate a circular spline with learnable limits.')
        if circular and not (np.allclose(x0, y0) and np.allclose(xf, yf)):
            raise ValueError('x0==y0 and xf==yf must hold for all periodic '
                             'degrees of freedom.')
        if min_bin_size <= 0.0:
            raise ValueError('The minimum bin size should be positive.')
        if not (0.0 < min_slope < 1.0):
            raise ValueError('The minimum slope should be between 0 and 1.')
        if fused not in _FUSED_POLICIES:
            raise ValueError(f'fused must be one of {_FUSED_POLICIES}, got '
                             f'{fused!r}.')

        for name, bound in (('x0', x0), ('xf', xf), ('y0', y0), ('yf', yf)):
            self.register_buffer(name, torch.as_tensor(
                bound, dtype=dtype, device=device))
        self.n_bins = int(n_bins)
        self.circular = bool(circular)
        self.identity_boundary_slopes = bool(identity_boundary_slopes)
        self.learn_lower_bound = bool(learn_lower_bound)
        self.learn_upper_bound = bool(learn_upper_bound)
        self.min_bin_size = float(min_bin_size)
        self.min_slope = float(min_slope)
        self.fused = fused
        self.remat = bool(remat)

    @property
    def n_parameters_per_feature(self) -> int:
        n = 3 * self.n_bins + 1
        if self.learn_lower_bound:
            n += 1
        if self.learn_upper_bound:
            n += 1
        if self.identity_boundary_slopes:
            n -= 1 if self.circular else 2
        return n

    # ------------------------------------------------------------------ #
    @property
    def _fused_kind(self):
        """The kernels' kind (:data:`~tfep_tpu_torch.ops.spline.KINDS`)
        for this configuration under 'auto' or 'always', else None."""
        if self.fused == 'never' or self.learn_lower_bound:
            return None
        flags = (self.identity_boundary_slopes, self.learn_upper_bound,
                 self.circular)
        return next((k for k, f in KINDS.items() if f == flags), None)

    @property
    def _fused_applicable(self) -> bool:
        """Whether the fused spline (kernels K1/K2) handles this
        configuration."""
        return self._fused_kind is not None

    def forward(self, x, parameters):
        kind = self._fused_kind
        if kind is not None:
            n = x.shape[-1]
            bounds = [torch.broadcast_to(b, (n,)).contiguous()
                      for b in (self.x0, self.xf, self.y0, self.yf)]
            # A slice of a wider conditioner output is read in place.
            if parameters.ndim != 2 or parameters.stride(-1) != 1:
                parameters = parameters.contiguous()
            y, dl = fused_spline(x.contiguous(), parameters, *bounds,
                                 self.n_bins, self.min_bin_size,
                                 self.min_slope, kind=kind)
            return y, torch.sum(dl, dim=-1)
        if self.remat:
            return checkpoint(self._forward_impl, x, parameters,
                              use_reentrant=False)
        return self._forward_impl(x, parameters)

    def _forward_impl(self, x, parameters):
        x0, y0, widths, heights, slopes, shifts = self._get_parameters(
            parameters)
        if self.circular:
            x = (x - x0 + shifts) % (self.xf - x0) + x0
        return neural_spline_transformer(x, x0, y0, widths, heights, slopes)

    def inverse(self, y, parameters):
        x0, y0, widths, heights, slopes, shifts = self._get_parameters(
            parameters)
        x, log_det_J = neural_spline_transformer_inverse(
            y, x0, y0, widths, heights, slopes)
        if shifts is not None:
            x = (x - x0 - shifts) % (self.xf - x0) + x0
        return x, log_det_J

    def get_identity_parameters(self, n_features: int) -> np.ndarray:
        """Zeros: equal bins (softmax), unit slopes (offset softplus), zero
        shifts and unit domain scale. Identity only when x0==y0, xf==yf."""
        if not (np.allclose(self.x0.cpu().numpy(), self.y0.cpu().numpy())
                and np.allclose(self.xf.cpu().numpy(),
                                self.yf.cpu().numpy())):
            raise ValueError('The identity neural spline transformer can be '
                             'implemented only if x0=y0 and xf=yf.')
        return np.zeros(self.n_parameters_per_feature * n_features)

    def get_degrees_out(self, degrees_in: np.ndarray) -> np.ndarray:
        return np.tile(np.asarray(degrees_in), self.n_parameters_per_feature)

    def slice_features(self, feature_indices) -> 'NeuralSplineTransformer':
        """Feature-subset view: per-feature domain bounds are gathered.

        A scalar (0-d) bound broadcasts over all features, so it is kept.
        The view shares every other setting with this transformer.
        """
        view = copy.copy(self)
        view._buffers = {
            name: bound if bound.ndim == 0 else bound[feature_indices]
            for name, bound in self._buffers.items()}
        return view

    # ------------------------------------------------------------------ #
    def _get_parameters(self, parameters):
        """Normalize raw conditioner outputs into knot widths/heights/slopes.

        Returns x0, y0 broadcastable to (batch, n_features); widths/heights
        (batch, K, n_features); slopes (batch, K+1, n_features); shifts
        (batch, n_features) or None.
        """
        batch_size = parameters.shape[0]
        parameters = parameters.reshape(
            batch_size, self.n_parameters_per_feature, -1)
        K = self.n_bins

        widths = parameters[:, :K]
        heights = parameters[:, K:2 * K]

        if self.identity_boundary_slopes:
            n_slopes = K - 1
        elif self.circular:
            n_slopes = K
        else:
            n_slopes = K + 1
        slopes = parameters[:, 2 * K:2 * K + n_slopes]

        if self.circular:
            shifts = parameters[:, -1]
            if not self.identity_boundary_slopes:
                # Periodic boundary: first and last slopes identical.
                slopes = torch.cat([slopes, slopes[:, :1]], dim=1)
        else:
            shifts = None

        if self.identity_boundary_slopes:
            zeros = torch.zeros_like(widths[:, :1])
            slopes = torch.cat([zeros, slopes, zeros], dim=1)

        # Domain rescaling with minimum bin sizes.
        min_interval = K * self.min_bin_size
        rescaled_width = self.xf - self.x0 - min_interval
        rescaled_height = self.yf - self.y0 - min_interval
        if self.learn_lower_bound or self.learn_upper_bound:
            domain_scale = torch.exp(parameters[:, -1:])
            rescaled_width = rescaled_width * domain_scale
            rescaled_height = rescaled_height * domain_scale

        widths = (torch.softmax(widths, dim=1) * rescaled_width
                  + self.min_bin_size)
        heights = (torch.softmax(heights, dim=1) * rescaled_height
                   + self.min_bin_size)

        x0, y0 = self.x0, self.y0
        if self.learn_lower_bound and self.learn_upper_bound:
            domain_shift = parameters[:, -2]
            x0 = x0 + domain_shift
            y0 = y0 + domain_shift
        elif self.learn_lower_bound:
            # Fixed upper bound: the lower bound moves with the scaled width.
            x0 = self.xf - rescaled_width[:, 0] - min_interval
            y0 = self.yf - rescaled_height[:, 0] - min_interval

        # Offset so that zero parameters give slope exactly 1.
        slopes = softplus(slopes + spline_offset(self.min_slope)) \
            + self.min_slope

        return x0, y0, widths, heights, slopes, shifts


# =============================================================================
# Functional API
# =============================================================================

def _assign_bins(x, x0, y0, widths, heights, slopes, inverse):
    """Gather per-input bin quantities (widths, knots, slopes, s=h/w).

    Adds one huge outer bin on each side of the domain so out-of-domain
    inputs are transformed linearly with the boundary slopes. The JAX
    package selects the bin with a one-hot multiply-reduce (fast on the
    TPU); here it is a gather, which gives the same values.
    """
    batch_size, n_bins, n_features = widths.shape

    cum_width = torch.cumsum(widths, dim=1)
    cum_height = torch.cumsum(heights, dim=1)

    x0 = torch.broadcast_to(torch.atleast_1d(x0), (batch_size, n_features))
    y0 = torch.broadcast_to(torch.atleast_1d(y0), (batch_size, n_features))

    # Outer linear-extrapolation bins, 3 orders of magnitude wider.
    dx = cum_width[:, -1] * 1000.0
    dy0 = slopes[:, 0] * dx
    dyf = slopes[:, -1] * dx

    # knots_x/y: (batch, K+3, n_features).
    knots_x = torch.cat([
        (x0 - dx)[:, None], x0[:, None], x0[:, None] + cum_width,
        (x0 + cum_width[:, -1] + dx)[:, None]], dim=1)
    knots_y = torch.cat([
        (y0 - dy0)[:, None], y0[:, None], y0[:, None] + cum_height,
        (y0 + cum_height[:, -1] + dyf)[:, None]], dim=1)

    slopes = torch.cat([slopes[:, :1], slopes, slopes[:, -1:]], dim=1)
    widths = torch.cat([dx[:, None], widths, dx[:, None]], dim=1)
    heights = torch.cat([dy0[:, None], heights, dyf[:, None]], dim=1)

    knots = knots_y if inverse else knots_x
    bin_indices = torch.sum(x[:, None, :] > knots, dim=1) - 1
    bin_indices = torch.clamp(bin_indices, 0, n_bins + 1)[:, None]

    def take(arr, index=bin_indices):
        return torch.take_along_dim(arr, index, dim=1)[:, 0]

    widths_b_f = take(widths)
    heights_b_f = take(heights)
    lower_knot_x_b_f = take(knots_x)
    lower_knot_y_b_f = take(knots_y)
    slopes_k_b_f = take(slopes)
    slopes_k1_b_f = take(slopes, bin_indices + 1)
    s_b_f = heights_b_f / widths_b_f

    return (widths_b_f, heights_b_f, lower_knot_x_b_f, lower_knot_y_b_f,
            slopes_k_b_f, slopes_k1_b_f, s_b_f)


def _log_dy_dx(slopes_k, slopes_k1, s, eps, eps_1meps, eps2):
    numerator = s ** 2 * (slopes_k1 * eps2 + 2 * s * eps_1meps
                          + slopes_k * (1 - eps) ** 2)
    denominator = (s + (slopes_k1 + slopes_k - 2 * s) * eps_1meps) ** 2
    return torch.log(numerator) - torch.log(denominator)


def neural_spline_transformer(x, x0, y0, widths, heights, slopes):
    """Monotonic rational-quadratic spline; linear outside the domain.

    Parameters
    ----------
    x : torch.Tensor, shape (batch, n_features)
        Inputs; values outside ``[x0, x0 + sum(widths)]`` are transformed
        linearly with the boundary slopes.
    x0, y0 : torch.Tensor, shape (n_features,) or (batch, n_features)
        Lower input/output domain bounds.
    widths, heights : torch.Tensor, shape (batch, K, n_features)
        Positive bin widths/heights (they define the knots cumulatively).
    slopes : torch.Tensor, shape (batch, K+1, n_features)
        Positive derivative at each knot.

    Returns
    -------
    y : torch.Tensor, shape (batch, n_features)
    log_det_J : torch.Tensor, shape (batch,)
        Sum over features of ``log dy/dx``.
    """
    (widths_b_f, heights_b_f, lower_knot_x, lower_knot_y,
     slopes_k, slopes_k1, s) = _assign_bins(
        x, x0, y0, widths, heights, slopes, inverse=False)

    eps = (x - lower_knot_x) / widths_b_f
    eps_1meps = eps * (1 - eps)
    eps2 = eps ** 2

    numerator = heights_b_f * (s * eps2 + slopes_k * eps_1meps)
    denominator = s + (slopes_k1 + slopes_k - 2 * s) * eps_1meps
    y = lower_knot_y + numerator / denominator

    log_det_J = torch.sum(
        _log_dy_dx(slopes_k, slopes_k1, s, eps, eps_1meps, eps2), dim=1)
    return y, log_det_J


def neural_spline_transformer_inverse(y, x0, y0, widths, heights, slopes):
    """Analytic inverse (quadratic solve) of the rational-quadratic spline.

    Same arguments as :func:`neural_spline_transformer` with ``y`` in place
    of ``x``; returns ``(x, log_det_J)`` where ``log_det_J`` is the inverse
    map's Jacobian (the negative of the forward one at ``x``). The
    quadratic is solved in the numerically stable ``2c / (-b - sqrt(...))``
    form.
    """
    (widths_b_f, heights_b_f, lower_knot_x, lower_knot_y,
     slopes_k, slopes_k1, s) = _assign_bins(
        y, x0, y0, widths, heights, slopes, inverse=True)

    y_myk = y - lower_knot_y
    dk1_dk_m2s = slopes_k1 + slopes_k - 2 * s

    a = heights_b_f * (s - slopes_k) + y_myk * dk1_dk_m2s
    b = heights_b_f * slopes_k - y_myk * dk1_dk_m2s
    c = -s * y_myk

    eps = 2 * c / (-b - torch.sqrt(b ** 2 - 4 * a * c))
    x = eps * widths_b_f + lower_knot_x

    eps_1meps = eps * (1 - eps)
    eps2 = eps ** 2
    log_det_J = -torch.sum(
        _log_dy_dx(slopes_k, slopes_k1, s, eps, eps_1meps, eps2), dim=1)
    return x, log_det_J
