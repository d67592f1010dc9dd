"""Device ms per training step of the optimizer's kernels (AdamW), from the trace."""

from tfep_bench import tracing


def read(ctx):
    steps = ctx['record']['steps']
    if not steps:
        return None
    return tracing.kind_us(ctx['trace'], {'optimizer'}) / steps / 1e3
