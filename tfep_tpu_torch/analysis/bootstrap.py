"""Device-vectorized bootstrap analysis (scipy-like API).

The port of ``tfep_tpu/analysis/bootstrap.py``. All resampling happens on
the data's device: indices are drawn with a ``torch.Generator`` there, the
gather and the statistic evaluate as one batched computation per chunk,
and memory is controlled by chunking resamples (``batch``). Supports
percentile/basic confidence intervals, multiple bootstrap sample sizes,
``take_first_only`` (progressively-trained-map work values) and Bayesian
(Dirichlet-weighted) bootstrap. Reference behavior: upstream
tfep/analysis/bootstrap.py:24-262.

The draws follow the same laws as the JAX package's but not its values
(a ``torch.Generator`` is not JAX's PRNG). For each sample size, and for
each chunk of ``batch`` resamples in turn, one call draws

- the resample indices, ``torch.randint(0, max_idx, (batch, size))``, or
- with ``bayesian=True``, the Dirichlet(1, ..., 1) weights as
  ``exponential_()`` draws of shape ``(batch, size)`` in the data's dtype,
  each row divided by its sum,

so a caller with a generator seeded alike can draw them again.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Union

import numpy as np
import torch

from tfep_tpu_torch.device import resolve_device

__all__ = ['bootstrap', 'as_data_tensor']


def as_data_tensor(data, device=None) -> torch.Tensor:
    """A tensor stays where it is; numpy input goes to ``device`` (the
    card by default, see :func:`~tfep_tpu_torch.device.resolve_device`).
    The dtype is kept."""
    if isinstance(data, torch.Tensor):
        return data
    return torch.as_tensor(np.asarray(data), device=resolve_device(device))


def bootstrap(
        data,
        statistic: Callable,
        *,
        confidence_level: float = 0.95,
        n_resamples: int = 9999,
        bootstrap_sample_size: Optional[Union[int, List[int]]] = None,
        take_first_only: bool = False,
        batch: Optional[int] = None,
        method: str = 'percentile',
        bayesian: bool = False,
        seed: Optional[Union[int, torch.Generator]] = 0,
        device=None,
):
    """Compute the parameters of the bootstrap distribution of a statistic.

    Parameters
    ----------
    data : tensor or array
        Shape ``(n_samples,)`` or ``(n_samples, ...)``. A tensor stays on
        its device; an array goes to ``device``.
    statistic : Callable
        Takes resampled data and a ``vectorized`` keyword; when vectorized the
        data has a leading resample axis and the return must have shape
        ``(batch,)``. With ``bayesian=True`` it must also accept ``weights``.
    confidence_level, n_resamples, bootstrap_sample_size, take_first_only,
    batch, method, bayesian :
        Same semantics as the reference (bootstrap.py:24-182).
    seed : int or torch.Generator, optional
        Seed of the resampling, or a generator on the data's device.
    device : str or torch.device, optional
        Where numpy ``data`` goes (the card by default).

    Returns
    -------
    result : dict or list of dict
        Keys: ``confidence_interval`` ({'low','high'}), ``standard_deviation``,
        ``mean``, ``median`` (0-d tensors). A list when multiple sample sizes
        are requested.
    """
    data = as_data_tensor(data, device)
    n_samples = data.shape[0]
    if isinstance(seed, torch.Generator):
        generator = seed
    else:
        generator = torch.Generator(device=data.device)
        generator.manual_seed(0 if seed is None else int(seed))

    single_size = bootstrap_sample_size is None or isinstance(
        bootstrap_sample_size, (int, np.integer))
    if bootstrap_sample_size is None:
        sizes = [n_samples]
    elif single_size:
        sizes = [int(bootstrap_sample_size)]
    else:
        sizes = [int(s) for s in bootstrap_sample_size]
        if bayesian and not take_first_only:
            raise ValueError(
                'With Bayesian bootstrapping, specifying a '
                'bootstrap_sample_size is supported only when take_first_only '
                'is True.')
    if (bayesian and not take_first_only
            and any(s != n_samples for s in sizes)):
        raise ValueError(
            'With Bayesian bootstrapping, specifying a bootstrap_sample_size '
            'is supported only when take_first_only is True.')

    if batch is None:
        batch = n_resamples

    results = []
    for sample_size in sizes:
        stats_chunks = []
        for k in range(0, n_resamples, batch):
            batch_actual = min(batch, n_resamples - k)
            if bayesian:
                # Dirichlet(1, ..., 1): unit exponentials over their sum.
                weights = torch.empty(
                    (batch_actual, sample_size), dtype=data.dtype,
                    device=data.device).exponential_(generator=generator)
                weights = weights / weights.sum(dim=-1, keepdim=True)
                chunk_data = data[:sample_size].expand(
                    batch_actual, *data[:sample_size].shape)
                chunk = statistic(chunk_data, weights=weights,
                                  vectorized=True)
            else:
                max_idx = sample_size if take_first_only else n_samples
                idx = torch.randint(0, max_idx, (batch_actual, sample_size),
                                    generator=generator, device=data.device)
                chunk = statistic(data[idx], vectorized=True)
            stats_chunks.append(torch.atleast_1d(chunk))
        bootstrap_statistics = torch.cat(stats_chunks)

        alpha = (1 - confidence_level) / 2
        # torch.quantile interpolates linearly, as jnp.quantile does.
        ci_l, ci_u = torch.quantile(
            bootstrap_statistics,
            torch.tensor([alpha, 1 - alpha], dtype=bootstrap_statistics.dtype,
                         device=bootstrap_statistics.device))

        if method == 'basic':
            full_statistic = statistic(data[None], vectorized=True)[0]
            ci_l, ci_u = 2 * full_statistic - ci_u, 2 * full_statistic - ci_l
        elif method != 'percentile':
            raise ValueError("method must be 'percentile' or 'basic'.")

        results.append(dict(
            confidence_interval=dict(low=ci_l, high=ci_u),
            standard_deviation=torch.std(bootstrap_statistics, correction=1),
            mean=torch.mean(bootstrap_statistics),
            # torch.median returns the lower middle value of an even count;
            # the 0.5 quantile averages the two, as jnp.median does.
            median=torch.quantile(bootstrap_statistics, 0.5),
        ))

    # Like the reference (bootstrap.py:180-182), a single size returns the
    # bare dict even when it was spelled as a 1-element sequence.
    if len(results) == 1:
        return results[0]
    return results
