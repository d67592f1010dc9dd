"""K1 and K2's share of their roofline (%): over the traced window's
launches, the least time each could take (the larger of its operations
over the float32 peak and its bytes over the memory bandwidth, from the
frozen counts at the launch's shape) over their measured device time."""

from tfep_bench import peaks, tracing

KERNELS = {'forward_kernel': 'K1', 'backward_kernel': 'K2'}


def roofline(ctx, kernels, rows):
    bound_s = getattr(ctx['counts'], 'launch_bound_s', None)
    card = peaks.of(ctx['card'].get('kind'))
    found = tracing.launches(ctx['trace'], lambda n: n in kernels)
    if bound_s is None or card is None or not found:
        return None
    least = sum(bound_s(kernels[n.lower()], rows, ctx['cfg'], card)
                for n, _ in found)
    return 100.0 * least / (sum(d for _, d in found) / 1e6)


def read(ctx):
    return roofline(ctx, KERNELS, int(ctx['traffic']['batch']))
