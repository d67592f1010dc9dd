"""Weights and sub-seeds drawn from a run's seed.

Every trained leaf comes out of one uniform draw on the device, split and
scaled leaf by leaf, so that a run's weights cost one kernel and the same
seed gives the same weights.
"""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed."""
    words = [int(seed) % (1 << 64)] + [ord(c) for c in tag]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def draw(spec, seed: int, device, dtype=torch.float32):
    """``{key: tensor}`` for ``spec``, a list of ``(key, shape, low,
    high)``: each leaf uniform in ``[low, high)``."""
    sizes = [int(np.prod(shape)) for _, shape, _, _ in spec]
    flat = torch.rand(sum(sizes), generator=generator(seed, 'weights',
                                                      device),
                      device=device, dtype=dtype)
    out = {}
    for (key, shape, low, high), part in zip(spec, flat.split(sizes)):
        out[key] = (low + (high - low) * part).reshape(shape)
    return out
