"""The port's distributed example runs end to end at reduced size.

``tfep_tpu_torch/examples/distributed_tfep.py`` is the port of
``examples/distributed_tfep.py`` (the production topology at toy scale:
2 processes of a gloo group, a frame shard and an engine per rank with
the engine overlapped, per-rank TFEP loggers, rank 0's multimap estimate
with a bootstrap interval). The example asserts its own correctness
(identical losses on both ranks, the interval against the analytic Δf,
with the JAX example's margin); this test drives it on the CPU with the
sizes of ``tests/parallel/test_distributed_example.py``.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_distributed_tfep_example(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, DIST_TFEP_DEVICE='cpu',
               DIST_TFEP_FRAMES='256', DIST_TFEP_BATCH='32',
               DIST_TFEP_EPOCHS='6', OMP_NUM_THREADS='1')
    out = subprocess.run(
        [sys.executable, '-m', 'tfep_tpu_torch.examples.distributed_tfep'],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    assert 'DISTRIBUTED TFEP OK' in out.stdout
    assert 'steps: 24 ' in out.stdout


def test_example_imports_no_jax():
    """The example's process imports the port alone."""
    script = ('import sys, tfep_tpu_torch.examples.distributed_tfep\n'
              'assert not any(m == "jax" or m.startswith("jax.")\n'
              '               or m.split(".")[0] == "tfep_tpu"\n'
              '               for m in sys.modules)\n')
    out = subprocess.run([sys.executable, '-c', script],
                         env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
