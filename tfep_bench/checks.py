"""The numbers that decide ``correct``: gaps between what the program's timed
path produced and what the plain reference gives for the same inputs.

Training (the first steps of the run, through the window's own call):
- ``loss``: the largest relative gap of a step's loss;
- ``grad``: the first step's gradient, as the optimizer holds it, by the
  worst leaf: the gap between the program's norm and the reference's,
  over the larger of the reference's norm and the median leaf's;
- ``update``: the weights' change over the checked steps, by the worst
  leaf the same way, over the leaves whose reference gradient is at least
  a thousandth of the median leaf's (the others move by round-off alone
  under Adam's normalization).

Evaluation (every frame of every pass in the window, against the
reference in float64): the 99th percentile of the gaps of the reduced
potential (kT) and of ``log_det_J``, their widest gaps over the frames
float32 computes well, and the returned sample indices that are not the
frames' own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: A leaf whose reference gradient norm is under this share of the median
#: leaf's moves by round-off alone and is left out of ``update``.
STILL_LEAF = 1e-3


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items() if v.numel()}


def leaf_gap(program, reference, leaves=None) -> float:
    """The worst leaf's ``| |p| - |r| | / max(|r|, median |r|)``; infinite
    where a norm is not finite or no leaf is left."""
    p, r = _norms(program), _norms(reference)
    keys = sorted(r if leaves is None else leaves)
    median = float(np.median([r[k] for k in r]))
    gaps = [abs(p[k] - r[k]) / max(r[k], median) for k in keys]
    if not gaps or not all(math.isfinite(g) for g in gaps):
        return math.inf
    return max(gaps)


def moving_leaves(grads) -> list:
    """The leaves whose gradient norm is at least :data:`STILL_LEAF` of the
    median leaf's (every leaf where a norm is not finite)."""
    g = _norms(grads)
    median = float(np.median(list(g.values())))
    if not math.isfinite(median):
        return list(g)
    return [k for k, v in g.items() if not v >= 0 or v >= STILL_LEAF * median]


def training_gaps(program, reference, initial) -> dict:
    """``program`` and ``reference``: ``(losses, first gradient, weights
    after the checked steps)``; ``initial``: the weights before them."""
    p_loss, p_grad, p_after = program
    r_loss, r_grad, r_after = reference
    n = len(r_loss)
    if len(p_loss) < n:
        return dict(loss=math.inf, grad=math.inf, update=math.inf)
    loss = max(abs(a - b) / max(abs(b), 1.0)
               for a, b in zip(p_loss[:n], r_loss))
    if not all(math.isfinite(x) for x in p_loss[:n]):
        loss = math.inf
    p_move = {k: p_after[k].double() - initial[k].double() for k in initial}
    r_move = {k: r_after[k].double() - initial[k].double() for k in initial}
    return dict(loss=loss, grad=leaf_gap(p_grad, r_grad),
                update=leaf_gap(p_move, r_move, moving_leaves(r_grad)))


#: A frame whose reference answers in float32 and in float64 differ by more
#: than these (kT, and nats of log_det_J) is ill-conditioned in float32 (its
#: reference frame: a few frames in ten thousand); its widest gap is not
#: held, its gap counts in the percentiles.
ILL_CONDITIONED = dict(potential=1e-2, log_det_J=1e-4)


def evaluation_gaps(passes, single, double) -> dict:
    """``passes``: the program's ``run_evaluation`` results in the window;
    ``single``, ``double``: the reference's ``(potential, log_det_J)`` for
    every frame in float32 and in float64. Against float64, over every
    frame of every pass, the 99th percentile of the gaps (a loss of
    precision over all of them) and the widest gap over the frames that
    float32 computes well (a single wrong answer)."""
    out = {}
    if not passes:
        return dict(potential_max=math.inf, potential_p99=math.inf,
                    log_det_J_max=math.inf, log_det_J_p99=math.inf,
                    misplaced=0)
    for i, key in enumerate(('potential', 'log_det_J')):
        want = np.asarray(double[i], np.float64)
        well = np.abs(np.asarray(single[i], np.float64) - want) \
            <= ILL_CONDITIONED[key]
        gaps = np.stack([np.abs(np.asarray(p[key], np.float64) - want)
                         for p in passes])
        gaps = np.where(np.isfinite(gaps), gaps, np.inf)
        out[f'{key}_max'] = float(np.max(gaps[:, well]))
        out[f'{key}_p99'] = float(np.quantile(gaps, 0.99))
    out['misplaced'] = sum(
        int(np.sum(np.asarray(p['dataset_sample_index'])
                   != np.arange(len(want)))) for p in passes)
    return out


def judge(gaps, limits) -> tuple:
    """``(correct, [(name, value, limit)])`` over the numbers that
    ``limits`` names: each at or under its limit."""
    rows = [(name, float(gaps.get(name, math.inf)), float(limit))
            for name, limit in limits.items()]
    ok = all(math.isfinite(value) and value <= limit
             for _, value, limit in rows)
    return ok, rows
