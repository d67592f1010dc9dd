"""Device selection shared by every entry point of the port, and the
index tensors that are a module's fixed structure."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch import nn

__all__ = ['resolve_device', 'StaticIndices']


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point builds its tensors on.

    ``None`` means the card. Without a card, ``None`` raises instead of
    quietly using the CPU: CPU runs (the tests) pass ``device='cpu'``.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'No CUDA device is available. Pass device="cpu" explicitly to '
            'build on the CPU.')
    return torch.device('cuda')


class StaticIndices(nn.Module):
    """Integer index tensors that are structure fixed when a module is
    built, not state.

    The JAX package keeps such indices as static fields, so they are no
    leaves of its modules. Here they are built once on the device and
    follow the module through ``.to()``, but stay out of ``state_dict``
    and ``named_buffers``: a JAX module's leaves still load with no key
    missing or extra, and a forward pass copies no index from the host.
    Each entry is one index array or a tuple of them.

    >>> table = StaticIndices('cpu', groups=([0, 2], [1]))
    >>> table['groups'][0].tolist()
    [0, 2]
    """

    def __init__(self, device=None, **indices):
        super().__init__()
        device = resolve_device(device)

        def tensor(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=device)

        self._indices = {
            name: tuple(tensor(a) for a in value)
            if isinstance(value, tuple) else tensor(value)
            for name, value in indices.items()}

    def __getitem__(self, name):
        return self._indices[name]

    def _apply(self, fn, recurse=True):
        self._indices = {
            name: tuple(fn(t) for t in value)
            if isinstance(value, tuple) else fn(value)
            for name, value in self._indices.items()}
        return super()._apply(fn, recurse)
