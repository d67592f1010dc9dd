"""The optimizers of the examples: AdamW with optax's defaults, a cosine
learning-rate schedule and clipping by the global gradient norm.

Each factory returns ``params -> torch.optim.Optimizer``, as
``Trainer(optimizer=...)`` and :func:`tfep_tpu_torch.nn.ensemble.ensemble_init`
take. The rules are optax's, so the examples train as their JAX originals:

- ``adamw(lr)`` is ``optax.adamw(lr)``: b1 0.9, b2 0.999, eps 1e-8 and a
  weight decay of 1e-4, multiplied by the (scheduled) learning rate, as
  in ``torch.optim.AdamW``;
- a schedule is a function of the update count, which starts at 0: update
  ``k`` (0-based) uses ``schedule(k)``. The count lives in each parameter
  group (``'update_count'``), so it is saved in the optimizer's
  ``state_dict`` and a checkpoint resumes the schedule;
- ``max_grad_norm`` chains ``optax.clip_by_global_norm`` before the
  update: where the norm of all the gradients exceeds ``max_norm``, each
  gradient becomes ``g / norm * max_norm``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch

__all__ = ['ScheduledAdamW', 'adamw', 'cosine_decay_schedule']


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``: ``init_value`` times
    ``(1 - alpha) * (1 + cos(pi * min(count, decay_steps) / decay_steps)) / 2
    + alpha``."""
    if decay_steps <= 0:
        raise ValueError('decay_steps must be positive.')

    def schedule(count: int) -> float:
        fraction = min(count, decay_steps) / decay_steps
        cosine = 0.5 * (1 + math.cos(math.pi * fraction))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


class ScheduledAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` whose learning rate is ``schedule(k)`` at
    update ``k``, optionally after clipping the gradients by their global
    norm."""

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float = 1e-4,
                 max_grad_norm: Optional[float] = None):
        super().__init__(params, lr=schedule(0), betas=(0.9, 0.999),
                         eps=1e-8, weight_decay=weight_decay)
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        for group in self.param_groups:
            group.setdefault('update_count', 0)

    @torch.no_grad()
    def step(self, closure=None):
        if self.max_grad_norm is not None:
            self._clip_by_global_norm()
        for group in self.param_groups:
            group['lr'] = self.schedule(group['update_count'])
            group['update_count'] += 1
        return super().step(closure)

    def _clip_by_global_norm(self):
        grads = [p.grad for group in self.param_groups
                 for p in group['params'] if p.grad is not None]
        if not grads:
            return
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clip = norm >= self.max_grad_norm
        for g in grads:
            # optax's order, g / norm * max_norm, decided on the device
            # (no sync for the comparison).
            g.copy_(torch.where(clip, g / norm * self.max_grad_norm, g))


def adamw(learning_rate: Union[float, Callable[[int], float]],
          weight_decay: float = 1e-4,
          max_grad_norm: Optional[float] = None
          ) -> Callable[..., torch.optim.Optimizer]:
    """The factory of ``optax.adamw(learning_rate)``, chained after
    ``optax.clip_by_global_norm(max_grad_norm)`` when that is given;
    ``learning_rate`` is a number or a schedule of the update count."""
    schedule = (learning_rate if callable(learning_rate)
                else (lambda count: learning_rate))

    def factory(params) -> torch.optim.Optimizer:
        return ScheduledAdamW(params, schedule, weight_decay=weight_decay,
                              max_grad_norm=max_grad_norm)

    return factory
