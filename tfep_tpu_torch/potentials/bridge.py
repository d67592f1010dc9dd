"""Host bridge: external engines as differentiable functions on the device.

Port of ``tfep_tpu/potentials/bridge.py``, where the engine call is a
``jax.pure_callback`` with a ``custom_vjp``. Here each ``make_callback_*``
returns a function that applies a ``torch.autograd.Function``: its forward
copies the positions to the host once, calls the host function on numpy
arrays and returns the result on the positions' device and in their dtype;
its backward is the TFEP contract. For energies the forward host call
returns ``(energies, forces)`` (forces from the same engine evaluation,
like the reference's ``precompute_gradient``) and the backward is
``grad = -forces * g`` — the reference autograd-Function pattern
(upstream tfep/potentials/ase.py:168-320). NaN policies are the host
function's responsibility (energies/forces containing NaN propagate to the
loss, which handles them with ``ignore_nan``).

Host functions receive numpy arrays of shape ``(batch, n_dofs)`` (and
optionally a cell and per-sample keys) and must return numpy arrays;
per-sample engine fan-out (process pools, SLURM) happens inside them via
:mod:`tfep_tpu_torch.parallel.strategies`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ['make_callback_potential', 'make_callback_forces']


def _to_host(value) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _like(array, x: torch.Tensor) -> torch.Tensor:
    """A host result as a tensor on ``x``'s device, in ``x``'s dtype."""
    return torch.as_tensor(np.asarray(array)).to(device=x.device,
                                                 dtype=x.dtype)


class _PotentialFunction(torch.autograd.Function):
    """Energies from the host; backward ``-forces * g``."""

    @staticmethod
    def forward(ctx, x, energy_and_forces_fn, energy_fn, *aux):
        """``energy_and_forces_fn`` is called when ``x`` needs a gradient
        (``energy_fn`` is then ``None``), ``energy_fn`` otherwise."""
        args = [_to_host(x)] + [_to_host(a) for a in aux]
        if energy_fn is None:
            energies, forces = energy_and_forces_fn(*args)
            ctx.save_for_backward(_like(forces, x))
        else:
            energies = energy_fn(*args)
        ctx.n_aux = len(aux)
        return _like(energies, x)

    @staticmethod
    def backward(ctx, g):
        forces, = ctx.saved_tensors
        return (-forces * g[:, None], None, None) + (None,) * ctx.n_aux


def make_callback_potential(
        energy_and_forces_fn: Callable,
        energy_fn: Optional[Callable] = None,
        has_cell: bool = False,
        n_aux: Optional[int] = None,
        vmap_method: str = 'sequential',
) -> Callable:
    """Wrap host energy(+forces) functions into a differentiable device fn.

    Parameters
    ----------
    energy_and_forces_fn : Callable
        ``(positions, *aux) -> (energies, forces)`` with numpy arrays;
        positions/forces shape ``(batch, n_dofs)``, energies ``(batch,)``.
        Used when the positions need a gradient and grad mode is on (one
        engine call per step; the forces are kept on the device for the
        backward).
    energy_fn : Callable, optional
        ``(positions, *aux) -> energies``. Used otherwise (the
        energy-only path); defaults to calling ``energy_and_forces_fn``
        and dropping forces (engines where forces are cheap).
    has_cell : bool
        Legacy alias for ``n_aux=1`` (a ``batch_cell`` second argument).
    n_aux : int, optional
        Number of auxiliary (non-differentiated) arguments following the
        positions — e.g. the box cell, or per-sample integer keys that
        must reach the host with the positions. Each is a tensor (on any
        device) or an array.
    vmap_method : str
        Accepted for the JAX package's signature; there is nothing to
        forward it to here.

    Returns
    -------
    potential : Callable
        ``potential(batch_positions, *aux) -> (batch,)`` energies,
        differentiable w.r.t. positions (cotangent ``-forces * g``).
    """
    del vmap_method
    if n_aux is None:
        n_aux = 1 if has_cell else 0
    if energy_fn is None:
        def energy_fn(*args):
            return energy_and_forces_fn(*args)[0]

    def potential(x, *aux):
        if len(aux) != n_aux:
            raise TypeError(f'expected {n_aux} auxiliary arguments after '
                            f'the positions, got {len(aux)}')
        with_forces = torch.is_grad_enabled() and x.requires_grad
        return _PotentialFunction.apply(
            x, energy_and_forces_fn, None if with_forces else energy_fn,
            *aux)

    return potential


class _ForcesFunction(torch.autograd.Function):
    """Forces from the host; backward by central finite differences."""

    @staticmethod
    def forward(ctx, x, forces_fn, fd_step, *aux):
        host_aux = [_to_host(a) for a in aux]
        ctx.save_for_backward(x)
        ctx.forces_fn, ctx.fd_step, ctx.host_aux = forces_fn, fd_step, host_aux
        return _like(forces_fn(_to_host(x), *host_aux), x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, = ctx.saved_tensors
        norm = torch.linalg.norm(g, dim=-1, keepdim=True)
        safe = torch.where(norm > 0, norm, torch.ones_like(norm))
        direction = g / safe

        def forces_at(z):
            return _like(ctx.forces_fn(_to_host(z), *ctx.host_aux), x)

        f_plus = forces_at(x + ctx.fd_step * direction)
        f_minus = forces_at(x - ctx.fd_step * direction)
        vhp = (f_plus - f_minus) / (2.0 * ctx.fd_step) * norm
        return (vhp, None, None) + (None,) * len(ctx.host_aux)


def make_callback_forces(
        energy_and_forces_fn: Callable,
        has_cell: bool = False,
        fd_step: float = 1e-4,
        vmap_method: str = 'sequential',
) -> Callable:
    """Differentiable engine *forces* for force-matching losses.

    Returns ``forces(batch_positions[, batch_cell]) -> (batch, n_dofs)``.
    The backward pass computes the vector-Hessian product by central finite
    differences of the engine forces along the (per-sample) cotangent
    direction — two extra engine evaluations — exploiting the symmetry of
    the Hessian (``v^T dF/dx = dF/dx v``); rows whose cotangent is zero
    get zero. The counterpart of the reference's double-backpropagation
    Function (upstream tfep/potentials/psi4.py:641-766). ``vmap_method`` is
    accepted for the JAX package's signature and ignored.
    """
    del vmap_method
    n_aux = 1 if has_cell else 0

    def host_forces(*args):
        return energy_and_forces_fn(*args)[1]

    def forces(x, *aux):
        if len(aux) != n_aux:
            raise TypeError(f'expected {n_aux} auxiliary arguments after '
                            f'the positions, got {len(aux)}')
        return _ForcesFunction.apply(x, host_forces, fd_step, *aux)

    return forces
