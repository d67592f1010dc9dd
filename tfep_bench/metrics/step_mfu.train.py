"""The whole training step's share of the card's float32 peak (%): the
FLOPs of a step from its shapes (``counts/<config>.py``: the dense products
three times the forward, plus the counted kernel operations, without
recomputation), times the traced steps, over the traced window."""

from tfep_bench import peaks, tracing


def mfu(ctx, training, rows):
    card = peaks.of(ctx['card'].get('kind'))
    steps = ctx['record']['steps']
    if card is None or not steps:
        return None
    flops = ctx['counts'].step_flops(ctx['cfg'], rows, training) * steps
    window_s = tracing.window_us(ctx['trace']) / 1e6
    return 100.0 * flops / window_s / card['fp32_flops']


def read(ctx):
    return mfu(ctx, True, int(ctx['traffic']['batch']))
