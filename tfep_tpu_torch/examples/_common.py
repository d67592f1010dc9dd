"""What the example modules share: the command line, the work directory
and the bootstrapped FEP estimate."""

from __future__ import annotations

import argparse
import tempfile
from typing import Optional

import numpy as np
import torch

from tfep_tpu_torch.analysis import bootstrap, fep_estimator

__all__ = ['parse_args', 'make_workdir', 'estimate', 'identity_fep']


def parse_args(argv=None, description: Optional[str] = None):
    """``--device`` (the card by default) and ``--workdir`` (a fresh
    temporary directory by default)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument('--device', default=None,
                        help="'cuda' (the default) or 'cpu'")
    parser.add_argument('--workdir', default=None,
                        help='where logs and checkpoints go')
    return parser.parse_args(argv)


def make_workdir(workdir: Optional[str], name: str) -> str:
    """``workdir``, or a fresh temporary directory named after the
    example."""
    return workdir or tempfile.mkdtemp(prefix=f'{name}_')


def _statistic(d, vectorized=False, weights=None):
    return fep_estimator(d, weights=weights, vectorized=vectorized)


def estimate(work, device, n_resamples: int = 500, seed: int = 1):
    """``(df, low, high)``: the FEP estimate of the work values (kT) and
    the bootstrap percentile interval, computed on ``device``."""
    work = torch.as_tensor(np.asarray(work), dtype=torch.float64,
                           device=device)
    boot = bootstrap(work, _statistic, n_resamples=n_resamples, seed=seed)
    return (float(fep_estimator(work)),
            float(boot['confidence_interval']['low']),
            float(boot['confidence_interval']['high']))


def identity_fep(work, device) -> float:
    """The standard FEP estimate (identity map) of work values (kT)."""
    return float(fep_estimator(torch.as_tensor(
        np.asarray(work), dtype=torch.float64, device=device)))
