"""K1's share of its roofline (%) in an evaluation: as
``spline_roofline.train``, at the evaluation's batch."""

from tfep_bench.harness import BENCH, load


def read(ctx):
    train = load(BENCH / 'metrics' / 'spline_roofline.train.py')
    return train.roofline(ctx, {'forward_kernel': 'K1'},
                          int(ctx['traffic']['eval_batch']))
