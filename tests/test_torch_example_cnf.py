"""The port's ``cnf_tfep`` example on the CPU at a reduced size.

The full example (2048 frames, 240 Hutchinson steps of batch 256, then the
exact trace over every frame) takes about 3 s a step on the CPU in
float64, so here it runs on the example's first 48 frames for 3 steps of
16, with its seeds, map and optimizer, and holds the checks that do not
depend on the size: the trained flow, evaluated with the exact trace,
keeps every centroid to 1e-8. The interval against the analytic df and
the variance reduction are held on the card (``chip_smoke.py``).
"""

import numpy as np
import torch

from tfep_tpu_torch.examples import cnf_tfep


def test_cnf_reduced(tmp_path):
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        results = cnf_tfep.run('cpu', str(tmp_path), n_frames=48,
                               max_epochs=1, batch_size=16, n_resamples=100)
    finally:
        torch.set_num_threads(previous)
    cnf_tfep.check(results, statistical=False)
    assert results['steps'] == 3
    low, high = results['ci']
    assert np.isfinite([results['df'], low, high, results['var_mapped']]).all()
    # The training moved the map off the identity.
    assert results['var_mapped'] != results['var_identity']
