"""The evaluation's share of the card's float32 peak (%): as
``step_mfu.train``, the forward only, per batch of the evaluation."""

from tfep_bench.harness import BENCH, load


def read(ctx):
    train = load(BENCH / 'metrics' / 'step_mfu.train.py')
    return train.mfu(ctx, False, int(ctx['traffic']['eval_batch']))
