"""A later change adds a configuration, a traffic mix, a cell or a metric
as new files and entries in ``BENCHMARK.json``: in a copy of the
benchmark, a dummy of each is added and run, and no file that was there
changes."""

import hashlib
import json
import shutil
import subprocess
import sys

from tfep_bench.harness import BENCH

ROOT = BENCH.parent


def digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob('*'))
            if p.is_file() and '__pycache__' not in p.parts}


def test_additions_need_no_edit(tmp_path):
    copy = tmp_path / 'tfep_bench'
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        '__pycache__'))
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    before = digests(tmp_path)

    # A configuration: the flagship's files under a new name, smaller.
    cfg = json.loads((copy / 'configs' / 'mixed_maf_helix32.json')
                     .read_text())
    cfg.update(name='mixed_dummy', n_atoms=6, n_maf_layers=2, n_bins=4,
               dtype='float64')
    (copy / 'configs' / 'mixed_dummy.json').write_text(json.dumps(cfg))
    for part in ('configs', 'reference', 'counts'):
        shutil.copy(copy / part / 'mixed_maf_helix32.py',
                    copy / part / 'mixed_dummy.py')
    # A traffic mix, a metric and a cell.
    (copy / 'traffic' / 'fit_b32.json').write_text(json.dumps(dict(
        entry='fit', frames=128, batch=32, check_steps=2,
        warmup_steps=2, trace_steps=1)))
    (copy / 'metrics' / 'dummy_steps.train.py').write_text(
        'def read(ctx):\n    return float(ctx["record"]["steps"])\n')
    (copy / 'limits' / 'mixed_dummy.fit.json').write_text(json.dumps(dict(
        limits=dict(loss=1e-9, grad=1e-9, update=1e-9))))
    bench = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    bench['configs'].append(dict(bench['configs'][0], name='mixed_dummy',
                                 file='tfep_bench/configs/mixed_dummy.json'))
    bench['workloads'].append(dict(name='mixed_dummy.fit',
                                   config='mixed_dummy', traffic='fit_b32',
                                   chips=1, why='a dummy'))
    for m in bench['end_to_end']:
        if 'workloads' in m and m['name'] == 'train_frames_per_s':
            m['workloads'].append('mixed_dummy.fit')
    bench['per_layer'].append(dict(
        name='dummy_steps.train', unit='steps', better='higher',
        source='program_counter', layer='app trainer',
        moves='train_frames_per_s', workloads=['mixed_dummy.fit']))
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))

    code = (
        'import sys, time, json; sys.path.insert(0, %r); '
        'sys.path.insert(1, %r)\n'
        'from tfep_bench import harness\n'
        'assert harness.BENCH == __import__("pathlib").Path(%r)\n'
        'cell = harness.Cell("mixed_dummy.fit")\n'
        'out = harness.run(cell, 5, 0.1, True, "cpu", time.perf_counter(),'
        ' dict(kind="cpu"))[0]\n'
        'print(json.dumps(out))\n' % (str(tmp_path), str(ROOT), str(copy)))
    done = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result['correct'] is True
    assert result['metrics']['dummy_steps.train']['value'] == 1.0

    after = digests(tmp_path)
    assert all(after[k] == v for k, v in before.items() if k !=
               'BENCHMARK.json')


def test_a_mix_asks_for_the_logger_and_checkpoints(tmp_path, monkeypatch):
    """``logger`` and ``checkpoint_every_n_steps`` in a traffic mix reach
    the program: it writes both into a directory of the run under
    ``TMPDIR``, which the run removes."""
    import tempfile
    from pathlib import Path

    import small
    from tfep_bench import harness

    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    written, rmtree = [], harness.shutil.rmtree

    def listed_rmtree(path, **kwargs):
        written.extend(str(p.relative_to(path)).split('/')[0]
                       for p in Path(path).rglob('*') if p.is_file())
        rmtree(path, **kwargs)

    monkeypatch.setattr(harness.shutil, 'rmtree', listed_rmtree)
    cell = small.cell('mixed_maf_helix32.train', logger=True,
                      checkpoint_every_n_steps=2)
    assert small.run(cell)[0]['correct'] is True
    assert {'tfep_logs', 'checkpoints'} <= set(written)
    assert list(tmp_path.iterdir()) == []
