"""Vmapped ensembles: train K independent flows at once on one card.

Port of ``tfep_tpu/nn/ensemble.py``. Training against an engine is
engine-bound: a batch holds the tens to few hundred frames the engine can
evaluate per step, which leaves the card mostly idle. Stacking K
structurally identical flows (independent seeds, replicas of a
hyperparameter sweep, a map-uncertainty estimate) and mapping the
training step over the member axis with ``torch.func.vmap`` fills that
room: the members' matrix products become batched products, and the
fused spline launches K1/K2 once for all members' rows
(:mod:`tfep_tpu_torch.ops.spline`).

A *stacked* module is a copy of the first member whose parameters carry a
leading member axis K; its buffers (degrees, masks, spline domains) are
the first member's and must be equal in every member. It is an ordinary
``nn.Module``, so ``state_dict``/``torch.save`` checkpoint it like one
flow, but it is not called directly: :func:`ensemble_map` and
:func:`make_ensemble_train_step` apply it member by member through
``torch.func.functional_call``, and :func:`unstack_module` returns the
members as modules.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ['stack_modules', 'unstack_module', 'n_members', 'ensemble_map',
           'ensemble_init', 'make_ensemble_train_step']


def _structure(module: nn.Module):
    """Module types and the names of parameters and buffers."""
    return ([(name, type(m)) for name, m in module.named_modules()],
            [name for name, _ in module.named_parameters()],
            [name for name, _ in module.named_buffers()])


def _same_buffer(a, b) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
    # NaN entries (sentinels) count as equal where they are aligned.
    return bool(np.array_equal(a, b, equal_nan=a.dtype.kind == 'f'))


def stack_modules(modules: Sequence[nn.Module]) -> nn.Module:
    """Stack K structurally identical modules into one ensemble module.

    Parameters gain a leading member axis K
    (``torch.func.stack_module_state``); buffers are taken from the first
    member. They encode structure (degrees, index tables, spline domains),
    so they must be equal in every member.

    Parameters
    ----------
    modules : sequence of nn.Module
        K >= 1 modules built with the same arguments, typically from
        different seeds.

    Returns
    -------
    nn.Module
        A copy of the first member holding the stacked parameters. Apply
        or train it with :func:`ensemble_map` and
        :func:`make_ensemble_train_step`; :func:`unstack_module` extracts
        members.
    """
    modules = list(modules)
    if not modules:
        raise ValueError('Need at least one module to stack.')
    buffers_0 = dict(modules[0].named_buffers())
    shapes_0 = [p.shape for p in modules[0].parameters()]
    for i, m in enumerate(modules[1:], start=1):
        if _structure(m) != _structure(modules[0]):
            raise ValueError(
                f'Member 0 and member {i} have different module structures: '
                f'ensemble members must be built with the same arguments '
                f'(only parameter values may differ).')
        for name, b in m.named_buffers():
            if not _same_buffer(buffers_0[name], b):
                raise ValueError(
                    f'Member 0 and member {i} differ in the buffer {name!r}: '
                    f'ensemble members must share structure; only '
                    f'parameters may differ.')
        if [p.shape for p in m.parameters()] != shapes_0:
            raise ValueError(f'Member 0 and member {i} have parameters of '
                             f'different shapes.')
    params, _ = torch.func.stack_module_state(modules)
    stacked = copy.deepcopy(modules[0])
    for name, value in params.items():
        _set_parameter(stacked, name, value)
    return stacked


def _set_parameter(module, name, value):
    owner, _, leaf = name.rpartition('.')
    owner = module.get_submodule(owner)
    setattr(owner, leaf, nn.Parameter(
        value, requires_grad=getattr(owner, leaf).requires_grad))


def n_members(stacked: nn.Module) -> int:
    """Member count K of a stacked ensemble (leading axis of a parameter)."""
    for p in stacked.parameters():
        return int(p.shape[0])
    raise ValueError('The ensemble has no parameters.')


def unstack_module(stacked: nn.Module, member: Optional[int] = None):
    """One member as an ``nn.Module`` (or, with ``member=None``, the list
    of all K). Each owns a copy of its parameters."""
    if member is None:
        return [unstack_module(stacked, k) for k in range(n_members(stacked))]
    # Copy everything but the stacked parameters, which become the
    # member's slices.
    memo = {id(p): nn.Parameter(p.detach()[member].clone(),
                                requires_grad=p.requires_grad)
            for p in stacked.parameters()}
    return copy.deepcopy(stacked, memo)


class _Apply(nn.Module):
    """``fn(member, *args)`` as a module's forward, so that
    ``functional_call`` can swap the member's parameters in for any
    method ``fn`` calls (``forward``, ``inverse``, ...)."""

    def __init__(self, member, fn):
        super().__init__()
        self.member = member
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.member, *args)


def _stacked_parameters(stacked):
    return {'member.' + name: p for name, p in stacked.named_parameters()}


def ensemble_map(fn: Callable, stacked: nn.Module, *args, member_axes=None):
    """``torch.func.vmap`` of ``fn(member, *args)`` over the members.

    Parameters
    ----------
    fn : callable
        Function of one (unstacked) module and ``*args``.
    stacked : nn.Module
        Ensemble built by :func:`stack_modules`.
    *args
        Extra arguments, shared by every member unless ``member_axes``
        maps them.
    member_axes : sequence of int or None, optional
        ``in_dims`` of ``*args`` (default: all ``None``, shared). Use ``0``
        for arguments with a leading member axis, e.g. per-member batches.

    Returns
    -------
    What ``fn`` returns, with a leading member axis K.
    """
    if member_axes is None:
        member_axes = (None,) * len(args)
    apply = _Apply(stacked, fn)

    def member(params, *a):
        return torch.func.functional_call(apply, params, a)

    return torch.func.vmap(member, in_dims=(0,) + tuple(member_axes))(
        _stacked_parameters(stacked), *args)


def ensemble_init(optimizer: Callable, stacked: nn.Module):
    """The optimizer of a stacked ensemble: ``optimizer`` (a factory
    ``params -> torch.optim.Optimizer``, as ``Trainer`` takes, e.g.
    :func:`tfep_tpu_torch.app.trainer.default_optimizer`) applied to the
    stacked parameters.

    An elementwise optimizer (AdamW, SGD, the default) then updates every
    member exactly as K separate optimizers would. Transforms over a
    member's whole gradient, such as clipping by its global norm, are
    :func:`make_ensemble_train_step`'s, member by member.
    """
    return optimizer(list(stacked.parameters()))


def _clip_by_global_norm(grads, max_norm):
    """Each member's gradients scaled to global norm ``max_norm`` where
    their norm exceeds it (``optax.clip_by_global_norm``'s rule, with no
    epsilon), the norm taken over that member's tensors only."""
    norm = torch.sqrt(sum(torch.sum(g.reshape(g.shape[0], -1) ** 2, dim=1)
                          for g in grads.values()))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    return {name: g * scale.reshape(-1, *([1] * (g.ndim - 1)))
            for name, g in grads.items()}


def make_ensemble_train_step(loss_fn: Callable, optimizer,
                             share_batch: bool = True,
                             has_aux: bool = False,
                             max_grad_norm: Optional[float] = None
                             ) -> Callable:
    """Build the per-member training step of a stacked ensemble.

    Parameters
    ----------
    loss_fn : callable
        ``loss_fn(member, batch) -> loss`` (or ``(loss, aux)`` with
        ``has_aux=True``) for one module.
    optimizer : torch.optim.Optimizer
        Built on the stacked parameters by :func:`ensemble_init`.
    share_batch : bool, optional
        If ``True`` (default) every member sees the same batch (seed
        ensembles); if ``False`` the batch carries a leading member axis
        (bootstrap or data-split ensembles).
    has_aux : bool, optional
        Whether ``loss_fn`` returns ``(loss, aux)``.
    max_grad_norm : float, optional
        Clip each member's gradients to this global norm before the
        optimizer's step, the member's norm alone deciding its scale (the
        counterpart of chaining ``optax.clip_by_global_norm`` before the
        JAX package's optimizer).

    Returns
    -------
    callable
        ``step(stacked, batch) -> losses`` (``(losses, aux)`` with
        ``has_aux=True``), losses of shape ``(K,)``. It updates the stacked
        parameters in place; each member's update equals its single-model
        step.
    """

    def step(stacked, batch):
        apply = _Apply(stacked, loss_fn)

        def member_loss(params, b):
            return torch.func.functional_call(apply, params, (b,))

        params = {name: p.detach()
                  for name, p in _stacked_parameters(stacked).items()}
        grads, values = torch.func.vmap(
            torch.func.grad_and_value(member_loss, has_aux=has_aux),
            in_dims=(0, None if share_batch else 0))(params, batch)
        if max_grad_norm is not None:
            grads = _clip_by_global_norm(grads, max_grad_norm)
        for name, p in _stacked_parameters(stacked).items():
            p.grad = grads[name]
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return values

    return step
