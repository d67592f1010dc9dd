"""Device ms per training step of cuBLAS's matrix products (the conditioner's, the EGNN's node-level MLPs), from the trace."""

from tfep_bench import tracing


def read(ctx):
    steps = ctx['record']['steps']
    if not steps:
        return None
    return tracing.kind_us(ctx['trace'], {'matmul'}) / steps / 1e3
