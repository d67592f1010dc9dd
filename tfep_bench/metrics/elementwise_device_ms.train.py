"""Device ms per training step of PyTorch's own elementwise and reduction kernels (the flow, the transformers, the Z-matrix conversion, the ODE solver), from the trace."""

from tfep_bench import tracing


def read(ctx):
    steps = ctx['record']['steps']
    if not steps:
        return None
    return tracing.kind_us(ctx['trace'], {'elementwise'}) / steps / 1e3
