"""Frames of the configurations' molecules, drawn on the device from a
run's seed."""

from __future__ import annotations

import numpy as np
import torch

from tfep_bench import weights as draws


def helix(cfg) -> np.ndarray:
    """``(n_atoms, 3)`` positions of a helical chain: ``cfg['helix']``
    gives its radius, its turn per atom (rad) and its rise per atom."""
    h = cfg['helix']
    n = int(cfg['n_atoms'])
    turns = np.arange(n) * h['turn_rad']
    return np.stack([h['radius'] * np.cos(turns),
                     h['radius'] * np.sin(turns),
                     h['rise'] * np.arange(n)], axis=1)


def helix_frames(cfg, n, seed, device):
    """``(n, 3 n_atoms)`` float32 frames (a trajectory's precision): the
    helix with ``cfg['helix']['noise']`` of Gaussian noise per
    coordinate."""
    base = torch.as_tensor(helix(cfg), dtype=torch.float32, device=device)
    noise = torch.randn((n, *base.shape), device=device,
                        generator=draws.generator(seed, 'frames', device))
    return (base + cfg['helix']['noise'] * noise).reshape(n, -1)
