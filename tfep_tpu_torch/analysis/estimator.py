"""(T)FEP free-energy estimator, bootstrap-compatible and device-vectorized.

The port of ``tfep_tpu/analysis/estimator.py`` to torch tensors, which stay
on the device they come in on (numpy input goes to ``device``, the card by
default) and keep their dtype.

``Δf = -kT * logsumexp(-w/kT + log_weights)`` over work values ``w``; biased
sampling enters through per-sample bias potentials (log-softmax weights) and
Bayesian bootstrap through explicit weights. The vectorized path maps over a
leading resample axis on the device, so a chunk of bootstrap resamples is
one batched computation. Reference behavior:
upstream tfep/analysis/estimator.py:24-86.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tfep_tpu_torch.analysis.bootstrap import as_data_tensor, bootstrap

__all__ = ['fep_estimator', 'estimate_from_logger']


def fep_estimator(data, kT: float = 1.0, weights=None,
                  vectorized: bool = False, device=None) -> torch.Tensor:
    """FEP estimator over work values (optionally with sample log-weights).

    Parameters
    ----------
    data : array
        Shape ``(n_samples,)`` (work values, kT units) or ``(n_samples, 2)``
        (``data[:, 0]`` work, ``data[:, 1]`` log-weights/bias). With
        ``vectorized=True`` an extra leading ``n_bootstraps`` axis is expected
        (``(n_bootstraps, n_samples)`` or ``(n_bootstraps, n_samples, 2)``).

        Note: the reference's docstring describes the biased layout as
        ``(2, n_samples)``, but its executable behavior
        (``work, bias = data.T``,
        upstream tfep/analysis/estimator.py:71) — and the only
        layout its/our ``bootstrap`` can resample along the sample axis —
        is ``(n_samples, 2)``; this framework follows the executable
        convention (asserted in tests/parity/test_analysis_parity.py).
    kT : float, optional
        Set if the work/bias values are not already in kT units.
    weights : array, optional
        Shape ``(n_bootstraps, n_samples)`` Bayesian-bootstrap weights
        (sum to 1 along the sample axis). Unbiased data only.
    vectorized : bool, optional
    device : str or torch.device, optional
        Where numpy ``data`` goes (the card by default); a tensor stays on
        its device.

    Returns
    -------
    df : scalar, or shape ``(n_bootstraps,)`` when vectorized.
    """
    data = as_data_tensor(data, device)
    if vectorized:
        if data.ndim == 2:
            work, bias = data, None
        else:
            # (n_bootstraps, n_samples, 2) -> two (n_bootstraps, n_samples).
            work, bias = data[..., 0], data[..., 1]
    else:
        if data.ndim == 1:
            work, bias = data, None
        else:
            if data.shape[-1] != 2:
                raise ValueError(
                    'Biased data must have shape (n_samples, 2) with '
                    'data[:, 0] the work values and data[:, 1] the '
                    f'log-weights, got {tuple(data.shape)}. (A (2, n_samples) '
                    'layout must be transposed.)')
            work, bias = data[..., 0], data[..., 1]

    if bias is None:
        if weights is None:
            log_weights = -torch.log(torch.tensor(
                work.shape[-1], dtype=work.dtype, device=work.device))
        else:
            log_weights = torch.log(torch.as_tensor(
                weights, dtype=work.dtype, device=work.device))
    elif weights is not None:
        raise NotImplementedError(
            'Bayesian bootstrapping is not supported with biased data.')
    else:
        log_weights = torch.log_softmax(bias / kT, dim=-1)

    return -kT * torch.logsumexp(-work / kT + log_weights, dim=-1)


def estimate_from_logger(
        logger,
        *,
        epoch_idx: Optional[int] = None,
        step_idx: Optional[int] = None,
        reference_potentials=None,
        bias_potentials=None,
        kT: float = 1.0,
        n_resamples: int = 2000,
        confidence_level: float = 0.95,
        method: str = 'percentile',
        seed=0,
        device=None,
) -> dict:
    """One-call TFEP estimate from a :class:`~tfep_tpu_torch.io.log.TFEPLogger`.

    Assembles the per-sample generalized work
    ``w_i = u_B(M(x_i)) - u_A(x_i) - log|det J_M(x_i)|`` from the logged
    ``potential``/``log_det_J`` columns (kT units, the training-step logging
    contract) and runs :func:`fep_estimator` plus a bootstrap confidence
    interval — the post-hoc recipe of the reference's multimap tutorial
    (upstream tfep docs/intro_to_MTFEP.ipynb) as a single call.

    Parameters
    ----------
    logger : TFEPLogger
        The logger a map trained with (``tfep_map.tfep_logger``), or one
        the JAX package's trainer wrote (the files are the same).
    epoch_idx : int or sequence of int, optional
        Read the train channel of this epoch. Exactly one of ``epoch_idx``
        and ``step_idx`` must be given. A sequence of epochs selects the
        **multimap** estimate (arXiv:2302.07683): each epoch's map
        contributes its own work values for every frame. Work values of
        the same frame under different maps share the frame, so the
        bootstrap resamples *frames* (clusters), drawing each frame's
        work under all maps together; frames without a (non-NaN) work
        value in every requested epoch are excluded.
    step_idx : int, optional
        Read the eval channel of this step instead (held-out frames —
        preferred for expressive maps, whose train-frame work is
        overfitting-biased).
    reference_potentials : array, optional
        Reduced reference potentials ``u_A/kT`` indexed by **dataset sample
        index** (full dataset length; the logged rows select their own
        entries). Omit only when the logged potential already is the work's
        potential term (e.g. ``ref_potentials`` were given to the loss).
    bias_potentials : array, optional
        Bias potentials ``V(x_i)`` (kT units when ``kT=1``) indexed by
        dataset sample index, for frames from a biased simulation; enters
        as log-softmax weights (reference estimator.py:56-66).
    kT : float, optional
        Unit of the logged values; estimates come back in the same unit.
    n_resamples, confidence_level, method, seed :
        Passed to :func:`tfep_tpu_torch.analysis.bootstrap.bootstrap`;
        ``seed`` is an int or a ``torch.Generator`` on ``device``.
    device : str or torch.device, optional
        Where the estimate and the bootstrap run (the card by default).

    Returns
    -------
    result : dict
        ``df`` (point estimate), ``confidence_interval`` ({'low','high'}),
        and the assembled work values with their provenance:

        - ``work``: the per-sample work (kT units, NaN rows dropped by the
          logger read). Single-map mode: shape ``(n_samples,)`` in the
          logger's storage order (epoch visitation order, NOT sorted by
          sample index). Multimap mode: shape ``(n_frames, n_maps)`` —
          row i holds frame ``sample_indices[i]``'s work under each
          requested epoch's map, in the order the epochs were given.
        - ``sample_indices``: dataset sample index of each ``work`` row,
          aligned with ``work``'s leading axis.
        - ``n_samples``: total work-value count, ``work.size`` (frames ×
          maps in multimap mode — each frame contributes one work value
          per map).
    """
    if (epoch_idx is None) == (step_idx is None):
        raise ValueError('Pass exactly one of epoch_idx or step_idx.')
    names = ['dataset_sample_index', 'potential', 'log_det_J']

    multimap = epoch_idx is not None and np.ndim(epoch_idx) > 0
    if step_idx is not None:
        datas = [logger.read_eval_tensors(names=names, step_idx=step_idx,
                                          remove_nans=True)]
    else:
        epochs = list(np.atleast_1d(epoch_idx)) if multimap else [epoch_idx]
        datas = [logger.read_train_tensors(names=names, epoch_idx=int(e),
                                           remove_nans=True)
                 for e in epochs]

    def block_work(data):
        sample_idx = np.asarray(data['dataset_sample_index']).astype(int)
        w = np.asarray(data['potential']) - np.asarray(data['log_det_J'])
        if reference_potentials is not None:
            w = w - np.asarray(reference_potentials)[sample_idx]
        return w, sample_idx

    blocks = [block_work(d) for d in datas]
    if multimap:
        # Work values of the same frame under different epochs' maps share
        # the frame x_i (strong dependence), so the bootstrap unit is the
        # frame: align the epochs on their common sample indices and stack
        # (n_frames, n_maps) so each resample draws whole frame rows.
        common = blocks[0][1]
        for _, s in blocks[1:]:
            common = np.intersect1d(common, s)
        if len(common) == 0:
            raise ValueError(
                'The requested epochs share no (non-NaN) sample indices; '
                'cannot assemble a multimap estimate.')
        columns = []
        for w, s in blocks:
            position = {int(v): i for i, v in enumerate(s)}
            columns.append(w[[position[int(v)] for v in common]])
        work = np.stack(columns, axis=-1)           # (n_frames, n_maps)
        sample_idx = common
        n_maps = work.shape[-1]
    else:
        work, sample_idx = blocks[0]
        n_maps = 1

    if bias_potentials is None:
        stat_data = as_data_tensor(work, device)

        def statistic(d, vectorized=False, weights=None):
            if multimap:
                # (..., n_frames, n_maps) -> (..., n_frames * n_maps); a
                # frame's Bayesian weight splits evenly over its maps.
                d = d.reshape(*d.shape[:-2], -1)
                if weights is not None:
                    weights = torch.repeat_interleave(weights / n_maps,
                                                      n_maps, dim=-1)
            return fep_estimator(d, kT=kT, weights=weights,
                                 vectorized=vectorized)
    else:
        bias = np.asarray(bias_potentials)[sample_idx]
        if multimap:
            bias = np.broadcast_to(bias[:, None], work.shape)
        stat_data = as_data_tensor(np.stack([work, bias], axis=-1), device)

        def statistic(d, vectorized=False, weights=None):
            if weights is not None:
                raise NotImplementedError(
                    'Bayesian bootstrapping is not supported with biased '
                    'data.')
            if multimap:
                # (..., n_frames, n_maps, 2) -> (..., n_frames * n_maps, 2)
                d = d.reshape(*d.shape[:-3], -1, 2)
            return fep_estimator(d, kT=kT, vectorized=vectorized)

    df = float(statistic(stat_data))
    boot = bootstrap(stat_data, statistic, n_resamples=n_resamples,
                     confidence_level=confidence_level, method=method,
                     seed=seed)
    return {
        'df': df,
        'confidence_interval': {
            'low': float(boot['confidence_interval']['low']),
            'high': float(boot['confidence_interval']['high']),
        },
        'n_samples': int(work.size),
        # (n_frames, n_maps) in multimap mode, flat otherwise; rows are
        # aligned with sample_indices (see docstring).
        'work': work,
        'sample_indices': np.asarray(sample_idx),
    }
