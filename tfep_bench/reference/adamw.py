"""AdamW written out, as ``torch.optim.AdamW`` defines it (decoupled weight
decay, bias-corrected moments), with the program's defaults: the plain
references' optimizer."""

from __future__ import annotations

import math


def adamw(weights, grads, state, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
          weight_decay=1e-4):
    """The weights after one step; ``state`` keeps the step count and the
    two moments between calls."""
    step = state['step'] = state.get('step', 0) + 1
    b1, b2 = betas
    out = {}
    for k, w in weights.items():
        g = grads[k]
        m = state.setdefault(f'm.{k}', g.new_zeros(g.shape))
        v = state.setdefault(f'v.{k}', g.new_zeros(g.shape))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = v.sqrt() / math.sqrt(1 - b2 ** step) + eps
        out[k] = w * (1 - lr * weight_decay) - lr / (1 - b1 ** step) * m / denom
    return out
