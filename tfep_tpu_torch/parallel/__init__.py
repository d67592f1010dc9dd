"""Execution runtime: strategies, CLI tools, launchers.

Port of ``tfep_tpu/parallel``. Not ported yet: ``sharding`` and
``distributed`` (data parallelism over the frames axis).
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
