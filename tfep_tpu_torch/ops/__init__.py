"""Hand-written Hopper kernels of the port, each beside its plain version."""


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
