"""Continuous normalizing flow (FFJORD-style) with optional regularization.

Port of ``tfep_tpu/nn/flows/continuous.py``. Integrates ``dx/dt = f(t, x)``
jointly with the instantaneous log-det (the trace of ``df/dx``) and,
optionally, the Finlay kinetic + Jacobian-Frobenius regularizer. Both the
trace and the Frobenius term use the forward-mode product ``J e``: from
the dynamics' ``forward_and_jvp`` where it has one (the fused EGNN path:
kernel K4 forward, K5 backward), else from ``torch.func.jvp``.

The JAX package draws its Hutchinson probes from a stored ``jax.random``
key; the port keeps the seed as its own state and draws them from a
``torch.Generator``, which gives other numbers. :meth:`ContinuousFlow.
integrate` takes the probes as an explicit tensor, so the two can be fed
the same ones.
"""

from __future__ import annotations

from typing import Optional

import torch

from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.nn.dynamics.masked import dynamics_jvp
from tfep_tpu_torch.nn.flows.flow import Flow
from tfep_tpu_torch.nn.ode import odeint

__all__ = ['ContinuousFlow']


def _uses_fused_kernels(dynamics) -> bool:
    """Whether the dynamics, unwrapped from adapters such as
    ``MaskedVelocityDynamics``, runs the fused EGNN kernels."""
    inner = dynamics
    while (not hasattr(inner, 'graph_layers')
           and hasattr(inner, 'dynamics')):
        inner = inner.dynamics
    return any(getattr(layer, 'pairwise', 'dense') == 'fused'
               for layer in getattr(inner, 'graph_layers', ()))


class ContinuousFlow(Flow):
    """Continuous normalizing flow over a dynamics network ``f(t, x)``.

    The time-1 map of ``dx/dt = f(t, x)``; the inverse integrates the
    negated field. Build with :meth:`create`.

    Attributes
    ----------
    dynamics : nn.Module
        The velocity field ``f(t, x)`` on ``(batch, dim)`` states.
    trace_estimator : {'hutchinson', 'exact'}
        ``'exact'`` takes one jvp per basis vector; ``'hutchinson'`` uses
        ``n_hutchinson_samples`` Gaussian probes.
    solver : {'euler', 'midpoint', 'rk4', 'dopri5'}
    n_steps : int
    regularization : bool
        Also integrate ``|f|^2 + |J e|^2`` and return it as a third output.
    checkpoint : bool
        Recompute each ODE step in the backward pass.
    seed : int
        Seed of the default probe generator.
    """

    def __init__(self, dynamics, trace_estimator='hutchinson',
                 solver='dopri5', n_steps=20, n_hutchinson_samples=1,
                 regularization=True, seed=0, checkpoint=True):
        super().__init__()
        self.dynamics = dynamics
        self.trace_estimator = trace_estimator
        self.solver = solver
        self.n_steps = int(n_steps)
        self.n_hutchinson_samples = int(n_hutchinson_samples)
        self.regularization = bool(regularization)
        self.seed = int(seed)
        self.checkpoint = bool(checkpoint)

    @classmethod
    def create(cls, dynamics, trace_estimator: str = 'hutchinson',
               solver: str = 'dopri5', n_steps: int = 20,
               n_hutchinson_samples: int = 1, regularization: bool = True,
               seed: int = 0, checkpoint: bool = True,
               device=None) -> 'ContinuousFlow':
        """Build a CNF and move it to ``device`` (default ``cuda``; raises
        without a card).

        The fused EGNN kernels compute one probe per evaluation, so
        dynamics that run them take only ``trace_estimator='hutchinson'``
        with one probe (as the JAX package's Pallas path).
        """
        if trace_estimator not in ('exact', 'hutchinson'):
            raise ValueError(
                "trace_estimator must be 'exact' or 'hutchinson'.")
        if _uses_fused_kernels(dynamics) and (
                trace_estimator == 'exact' or n_hutchinson_samples != 1):
            raise ValueError(
                "Dynamics with pairwise='fused' support only "
                "trace_estimator='hutchinson' with n_hutchinson_samples="
                '1 (the fused kernels take one probe at a time).')
        return cls(dynamics, trace_estimator, solver, n_steps,
                   n_hutchinson_samples, regularization, seed,
                   checkpoint).to(resolve_device(device))

    def n_parameters(self) -> int:
        return sum(p.numel() for p in self.dynamics.parameters())

    def probes(self, x, generator: Optional[torch.Generator] = None):
        """The Hutchinson probes ``(n_hutchinson_samples, *x.shape)`` for
        ``x``, from ``generator`` or, by default, a generator seeded with
        ``seed`` (deterministic, as the JAX package's stored key). ``None``
        for the exact trace."""
        if self.trace_estimator != 'hutchinson':
            return None
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(
                self.seed)
        return torch.randn((self.n_hutchinson_samples, *x.shape),
                           generator=generator, dtype=x.dtype,
                           device=x.device)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """Integrate ``x (batch, dim)`` from t=0 to t=1; returns ``(y,
        log_det_J)`` and, with ``regularization``, ``reg``, each ``(batch,)``
        but ``y``. Pass a fresh ``generator`` per training step for an
        unbiased trace."""
        return self.integrate(x, self.probes(x, generator), inverse=False)

    def inverse(self, y, generator: Optional[torch.Generator] = None):
        """Integrate the negated field backwards; same contract as
        :meth:`forward`. Exact only up to the fixed-grid discretization
        error of the solver."""
        return self.integrate(y, self.probes(y, generator), inverse=True)

    def integrate(self, x, eps, inverse: bool = False):
        """The pass of :meth:`forward` (or :meth:`inverse`) with explicit
        probes ``eps (n_hutchinson_samples, batch, dim)`` (``None`` for
        the exact trace)."""
        batch, dim = x.shape

        def integrand(tau, state):
            # The inverse runs the dynamics backwards: physical time
            # t = 1 - tau with a negated field.
            t = 1.0 - tau if inverse else tau
            xt = state[0]
            if self.trace_estimator == 'exact':
                eye = torch.eye(dim, dtype=x.dtype, device=x.device)
                # (dim, batch, dim): J columns for every basis vector.
                jvs = torch.stack([
                    dynamics_jvp(self.dynamics, t, xt, e.expand_as(xt))[1]
                    for e in eye])
                vel = self.dynamics(t, xt)
                trace = torch.einsum('ibi->b', jvs)
                frobenius = torch.sum(jvs ** 2, dim=(0, 2))
            elif self.n_hutchinson_samples == 1:
                vel, jv = dynamics_jvp(self.dynamics, t, xt, eps[0])
                trace = torch.sum(eps[0] * jv, dim=-1)
                frobenius = torch.sum(jv ** 2, dim=-1)
            else:
                pairs = [dynamics_jvp(self.dynamics, t, xt, e) for e in eps]
                vel = pairs[0][0]
                jvs = torch.stack([jv for _, jv in pairs])
                trace = torch.mean(torch.sum(eps * jvs, dim=-1), dim=0)
                frobenius = torch.mean(torch.sum(jvs ** 2, dim=-1), dim=0)

            if inverse:
                vel = -vel
                trace = -trace
            if self.regularization:
                return (vel, trace, torch.sum(vel ** 2, dim=-1) + frobenius)
            return (vel, trace)

        zeros = torch.zeros(batch, dtype=x.dtype, device=x.device)
        state0 = (x, zeros, zeros) if self.regularization else (x, zeros)
        return odeint(integrand, state0, 0.0, 1.0, n_steps=self.n_steps,
                      solver=self.solver, checkpoint=self.checkpoint)
