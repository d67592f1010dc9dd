"""Carry weights from a ``tfep_tpu`` module into its port.

The JAX package's modules are pytrees whose leaves are named by key paths
as ``jax.tree_util.keystr`` prints them (``.flows[0].conditioner.layers[2]
.gain``). The port keeps the same field names, with ``nn.ModuleList`` in
place of tuples, so each key path names one parameter or buffer of the
port (``flows.0.conditioner.layers.2.gain``). The caller flattens the JAX
module into ``{key path: numpy array}``; this module never touches JAX.
A stacked ensemble (the JAX package's ``stack_modules``) loads member by
member into the port's stacked module (:func:`load_jax_ensemble_state`).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

from tfep_tpu_torch.nn.ensemble import n_members, stack_modules, unstack_module

__all__ = ['torch_name', 'load_jax_state', 'load_jax_ensemble_state']


def torch_name(key_path: str) -> str:
    """The port's dotted name of a JAX key path.

    >>> torch_name('.flows[0].conditioner.layers[2].gain')
    'flows.0.conditioner.layers.2.gain'
    """
    name = re.sub(r'\[(\d+)\]', r'.\1', key_path)
    if not re.fullmatch(r'(\.\w+)+', name):
        raise ValueError(f'Not an attribute/index key path: {key_path!r}.')
    return name[1:]


@torch.no_grad()
def load_jax_state(module: nn.Module,
                   state: Mapping[str, np.ndarray]) -> nn.Module:
    """Load ``{JAX key path: array}`` into ``module`` in place.

    Floating-point leaves (parameters, and buffers such as domain bounds)
    are copied in the port's dtype and device. Integer and boolean leaves
    are structure fixed at construction (degrees, index tables, masks):
    they are checked for equality instead. Raises ``KeyError`` on any
    missing or extra key and ``ValueError`` on a shape or structure
    mismatch.

    Returns
    -------
    module : nn.Module
        The same module, for chaining.
    """
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    names = {torch_name(k): k for k in state}
    missing = sorted(set(targets) - set(names))
    extra = sorted(names[n] for n in set(names) - set(targets))
    if missing or extra:
        raise KeyError(f'State does not match the module: missing '
                       f'{missing}, extra {extra}.')
    for name, key in names.items():
        value = np.asarray(state[key])
        target = targets[name]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f'{key}: shape {tuple(value.shape)} does not '
                             f'match the port\'s {tuple(target.shape)}.')
        if target.is_floating_point():
            target.copy_(torch.from_numpy(np.array(value)))
        elif not np.array_equal(value, target.cpu().numpy()):
            raise ValueError(f'{key}: {target.dtype} structure differs '
                             f'from the port\'s.')
    return module


@torch.no_grad()
def load_jax_ensemble_state(stacked: nn.Module,
                            state: Mapping[str, np.ndarray]) -> nn.Module:
    """Load a JAX stacked ensemble's ``{key path: array}`` into the port's
    stacked module (:func:`tfep_tpu_torch.nn.ensemble.stack_modules`) in
    place.

    The leaves that are parameters of the port carry the leading member
    axis K; the buffers are shared. Each member is taken out with
    ``unstack_module``, loaded with :func:`load_jax_state` (which raises on
    any missing or extra key) and the members are stacked back.
    """
    k = n_members(stacked)
    stacked_names = {name for name, _ in stacked.named_parameters()}
    members = []
    for member in range(k):
        member_state = {}
        for key, value in state.items():
            value = np.asarray(value)
            if torch_name(key) in stacked_names:
                if value.shape[:1] != (k,):
                    raise ValueError(f'{key}: shape {value.shape} has no '
                                     f'leading member axis of {k}.')
                value = value[member]
            member_state[key] = value
        members.append(load_jax_state(unstack_module(stacked, member),
                                      member_state))
    for target, value in zip(stacked.parameters(),
                             stack_modules(members).parameters()):
        target.copy_(value)
    return stacked
