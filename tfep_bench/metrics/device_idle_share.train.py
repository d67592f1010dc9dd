"""The share of the traced window (%) in which no operation ran on the
device: 1 - (union of the device operations' intervals) / window."""

from tfep_bench import tracing


def read(ctx):
    t = ctx['trace']
    return 100.0 * (1.0 - tracing.busy_us(t) / tracing.window_us(t))
