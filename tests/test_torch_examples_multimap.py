"""The port's two multimap examples run on the CPU at their JAX examples'
sizes, with every check, the interval against the quadrature with the
JAX example's margin included (see ``test_torch_examples.py``)."""

import numpy as np
import pytest
import torch

from tfep_tpu_torch.examples import (
    multimap_tfep_mixed, multimap_tfep_triatomic,
)


@pytest.fixture(autouse=True)
def one_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.mark.parametrize('example, n_steps', [
    (multimap_tfep_triatomic, 40 * 4096 // 256),
    (multimap_tfep_mixed, 30 * 2048 // 256),
], ids=['triatomic', 'mixed'])
def test_multimap_example(example, n_steps, tmp_path):
    results = example.run('cpu', str(tmp_path))
    example.check(results, statistical=True)
    assert results['steps'] == n_steps
    low, high = results['ci']
    assert np.isfinite([results['df'], low, high]).all()
    # The map beats the identity: standard FEP is off by several kT.
    assert abs(results['df'] - results['df_analytic']) < \
        abs(results['df_fep'] - results['df_analytic'])
