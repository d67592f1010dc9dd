"""Device selection shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ['resolve_device']


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
