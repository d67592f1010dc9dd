"""PCA-whitened flow: runs the wrapped flow in whitened coordinates.

Port of ``tfep_tpu/nn/flows/pca.py``. The whitening matrix is estimated on
the host when the flow is built, with numpy in float64 (``np.linalg.eigh``
of the covariance, as in the JAX package, so both pick the same
eigenvector signs and so the same map); whitening and blackening are one
matrix product each. With ``blacken=True`` the whitening Jacobians cancel;
otherwise the constant ``-sum(log sigma_i)`` enters the log-det.
"""

from __future__ import annotations

import numpy as np
import torch

from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.nn.flows.flow import Flow

__all__ = ['PCAWhitenedFlow']


class PCAWhitenedFlow(Flow):
    """Whiten -> wrapped flow -> (optional) blacken.

    Runs the wrapped flow in PCA-whitened coordinates
    ``z = (x - mean) @ W`` where ``W = V diag(1/sigma)`` comes from the
    eigendecomposition ``cov = V diag(sigma^2) V^T`` of a data sample's
    covariance.

    With ``blacken=True`` (the default) the output is mapped back through
    the inverse transform, so the flow is an ``x -> x`` map and the two
    constant Jacobians cancel exactly. With ``blacken=False`` the flow maps
    ``x -> z`` space and the constant ``-sum(log sigma_i)`` enters the
    log-det.

    Build with :meth:`create`. Buffers, named as the JAX module's leaves:
    ``mean`` ``(n_features,)``, ``whitening_matrix`` and
    ``blackening_matrix`` ``(n_features, n_features)``, mutually inverse,
    and ``whitening_log_det_J`` (0-d).
    """

    def __init__(self, flow, mean, whitening_matrix, blackening_matrix,
                 whitening_log_det_J, blacken: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.flow = flow
        for name, value in (('mean', mean),
                            ('whitening_matrix', whitening_matrix),
                            ('blackening_matrix', blackening_matrix),
                            ('whitening_log_det_J', whitening_log_det_J)):
            self.register_buffer(name, torch.as_tensor(value, dtype=dtype))
        self.blacken = bool(blacken)

    @classmethod
    def create(cls, flow, x, blacken: bool = True, device=None,
               dtype: torch.dtype = torch.float32) -> 'PCAWhitenedFlow':
        """Estimate the whitening transform from data and wrap ``flow``.

        Parameters
        ----------
        flow : Flow
            The flow to run in whitened coordinates.
        x : array_like or torch.Tensor
            ``(n_samples, n_features)`` data sample used for the PCA
            estimate, taken to the host in float64. Needs at least
            ``n_features + 1`` linearly independent samples for a
            positive-definite covariance.
        blacken : bool, optional
            If ``True`` (default), map the wrapped flow's output back to
            the original coordinates so the overall map is ``x -> x``.
        device : str or torch.device, optional
            Defaults to ``cuda``; raises without a card.
        dtype : torch.dtype, optional
            Type of the buffers.

        Raises
        ------
        ValueError
            If the covariance estimate has negative eigenvalues (too few
            samples).
        """
        device = resolve_device(device)
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x, dtype=np.float64)
        mean = x.mean(axis=0)
        centered = x - mean
        cov = centered.T @ centered / (x.shape[0] - 1)

        eigvalues, eigvectors = np.linalg.eigh(cov)
        if np.any(eigvalues < 0.0):
            raise ValueError(
                'Cannot determine the PCA whitening matrix since some of the '
                'eigenvalues of the covariance matrix estimate are negative. '
                'Likely, this is due to an insufficient number of samples.')
        singular_values = np.sqrt(eigvalues)

        whitening = eigvectors @ np.diag(1.0 / singular_values)
        blackening = np.diag(singular_values) @ eigvectors.T
        log_det = -np.sum(np.log(singular_values))
        return cls(flow, mean, whitening, blackening, log_det,
                   blacken=blacken, dtype=dtype).to(device)

    def n_parameters(self) -> int:
        return self.flow.n_parameters()

    def _whiten(self, x):
        return (x - self.mean) @ self.whitening_matrix

    def _blacken(self, x):
        return x @ self.blackening_matrix + self.mean

    def forward(self, x):
        """Map ``(batch, n_features)`` inputs through whiten/flow/blacken.

        Returns ``(y, log_det_J, *extras)`` where the constant whitening
        log-det is included only when the map changes coordinate systems
        (``blacken=False``).
        """
        return self._pass(x, inverse=False)

    def inverse(self, y):
        """Invert :meth:`forward` (defined for any ``blacken`` setting)."""
        return self._pass(y, inverse=True)

    def _pass(self, x, inverse: bool):
        whiten = (not inverse) or self.blacken
        blacken = inverse or self.blacken

        if whiten:
            x = self._whiten(x)

        out = self.flow.inverse(x) if inverse else self.flow.forward(x)
        y, log_det_J = out[0], out[1]

        if blacken:
            y = self._blacken(y)

        if not (whiten and blacken):
            if whiten:
                log_det_J = log_det_J + self.whitening_log_det_J
            else:
                log_det_J = log_det_J - self.whitening_log_det_J

        return (y, log_det_J, *out[2:])
