"""Execution runtime: strategies, CLI tools, launchers, multi-process
training (process groups, device-mesh sharding).

Port of ``tfep_tpu/parallel``.
"""

from tfep_tpu_torch.parallel.strategies import (  # noqa: F401
    ParallelizationStrategy, SerialStrategy, ProcessPoolStrategy,
    ThreadPoolStrategy,
)
from tfep_tpu_torch.parallel.cli import (  # noqa: F401
    CLITool, CLIOption, KeyValueOption, AbsolutePathOption, FlagOption,
)
from tfep_tpu_torch.parallel.launcher import (  # noqa: F401
    Launcher, SRunTool, SRunLauncher,
)
from tfep_tpu_torch.parallel import distributed, sharding  # noqa: F401
