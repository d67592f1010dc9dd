"""The EGNN kernels' share of their roofline (%): over the traced window's
launches of K3, K4 and K5 (K5 with the reduction of its weight gradients,
``reduce_partials``), the least time each could take (the larger of its
operations over the float32 peak and its bytes over the memory bandwidth,
from the frozen counts at the launch's shape) over their measured device
time."""

from tfep_bench import peaks, tracing


def _kernel(name):
    if 'egnn_fwd_kernel' in name:
        return 'K4' if 'true' in name else 'K3'
    if 'egnn_kernel' in name:
        return 'K5'
    return None


def read(ctx):
    bound_s = getattr(ctx['counts'], 'egnn_bound_s', None)
    card = peaks.of(ctx['card'].get('kind'))
    found = tracing.launches(ctx['trace'], lambda n: 'egnn_' in n
                             or 'reduce_partials' in n)
    if bound_s is None or card is None or not found:
        return None
    rows = int(ctx['traffic']['batch'])
    least = sum(bound_s(_kernel(n.lower()), rows, ctx['cfg'], card)
                for n, _ in found if _kernel(n.lower()))
    return 100.0 * least / (sum(d for _, d in found) / 1e6)
