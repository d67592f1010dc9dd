"""Host ms per training step spent enqueuing the forward, the backward and
the update: ``Trainer.host_seconds['step']`` over the traced window."""


def read(ctx):
    seconds, calls = ctx['record']['host'].get('step', (0.0, 0))
    return seconds / calls * 1e3 if calls else None
