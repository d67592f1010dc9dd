"""Host ms per batch read (``get_batch`` and the copy into pinned memory,
on the prefetch thread): ``Trainer.host_seconds['read']`` over the traced
window."""


def read(ctx):
    seconds, calls = ctx['record']['host'].get('read', (0.0, 0))
    return seconds / calls * 1e3 if calls else None
