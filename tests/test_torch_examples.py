"""The port's examples run on the CPU with every check of the JAX
examples, the statistical ones included (the interval against the
analytic df with the JAX example's margin, the ensemble's spread).

Each runs at its JAX example's size, but ``solvated_preflow_tfep``, whose
full run takes about 70 s here: it runs on a quarter of the frames for 5
epochs and holds the checks that do not depend on the size (its full run
is on the card, in ``chip_smoke.py``). The two multimap examples are in
``test_torch_examples_multimap.py``, so that the files spread over test
workers.
"""

import numpy as np
import pytest
import torch

from tfep_tpu_torch.examples import (
    engine_in_the_loop_tfep, ensemble_tfep, solvated_preflow_tfep,
    toy_gaussian_tfep,
)


@pytest.fixture(autouse=True)
def one_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def assert_estimate(results):
    low, high = results['ci']
    assert np.isfinite([results['df'], low, high]).all()
    assert low <= results['df'] <= high


def test_toy_gaussian(tmp_path):
    results = toy_gaussian_tfep.run('cpu', str(tmp_path))
    toy_gaussian_tfep.check(results, statistical=True)
    assert results['steps'] == 40 * 2048 // 256
    assert_estimate(results)
    assert (tmp_path / 'ckpt' / 'last.ckpt').exists()


def test_ensemble():
    results = ensemble_tfep.run('cpu')
    ensemble_tfep.check(results, statistical=True)
    assert results['steps'] == 30 * 2048 // 256
    assert results['dfs'].shape == (ensemble_tfep.K_MEMBERS,)


def test_engine_in_the_loop(tmp_path, monkeypatch):
    """The spawned pool's processes read the latency from the
    environment."""
    monkeypatch.setenv('ENGINE_TFEP_LATENCY_S', '0')
    monkeypatch.setattr(engine_in_the_loop_tfep, 'ENGINE_LATENCY_S', 0.0)
    results = engine_in_the_loop_tfep.run('cpu', str(tmp_path))
    engine_in_the_loop_tfep.check(results, statistical=True)
    assert results['steps'] == 25 * 2048 // 256
    assert_estimate(results)
    # The engine ran on its own thread, overlapped with the flow.
    assert results['host_seconds']['engine'][1] == results['steps']


def test_solvated_preflow_reduced(tmp_path):
    results = solvated_preflow_tfep.run('cpu', str(tmp_path), n_frames=1024,
                                        n_epochs=5)
    solvated_preflow_tfep.check(results, statistical=False)
    assert results['steps'] == 5 * 1024 // 512
    assert_estimate(results)
