"""Compute ops of the port: the hand-written Hopper kernels, each beside its
plain version, and the Z-matrix conversion (``zmatrix``)."""


class LaunchCounter:
    """Kernel launches since the last :meth:`reset`, one int per kernel.

    Each launcher adds one where it launches its kernel and nowhere else,
    so a run can show that its main path went through the kernels.
    """

    def __init__(self, *kernels: str):
        self._kernels = kernels
        self.reset()

    def reset(self):
        for name in self._kernels:
            setattr(self, name, 0)


def fold_members(t, dim, n):
    """``(n, B, ...)`` with the ``vmap`` axis at ``dim`` (``None``: shared,
    broadcast to every member) as one contiguous ``(n * B, ...)``: the
    members' rows as one batch of a kernel."""
    t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.reshape(n * t.shape[1], *t.shape[2:]).contiguous()


def unfold_members(t, n):
    """The inverse of :func:`fold_members`: ``(n * B, ...)`` as
    ``(n, B, ...)``."""
    return t.reshape(n, t.shape[0] // n, *t.shape[1:])
