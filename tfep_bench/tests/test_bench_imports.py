"""Nothing the benchmark runs imports JAX or the JAX package, and the
references import nothing of the program. Top-level module names are
compared whole (``tfep_tpu_torch`` is not ``tfep_tpu``)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from tfep_bench import harness

BENCH = harness.BENCH
BANNED = {'jax', 'jaxlib', 'flax', 'tfep_tpu'}


def top_level_imports(path):
    tree = ast.parse(Path(path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob('*.py') if 'tests' not in p.parts)


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_in_the_benchmark(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize('path', sorted((BENCH / 'reference').glob('*.py')),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert 'tfep_tpu_torch' not in names and not names & BANNED
    assert names <= {'__future__', 'math', 'numpy', 'torch', 'tfep_bench'}


def test_whole_names_are_compared(monkeypatch):
    import types

    import tfep_tpu_torch  # noqa: F401
    assert 'tfep_tpu' not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, 'tfep_tpu.app',
                        types.ModuleType('tfep_tpu.app'))
    assert harness.banned_modules() == ['tfep_tpu']


def test_a_run_loads_no_jax():
    """A whole small run in a fresh process holds none of the banned
    modules afterwards (the guard run.py applies after the window)."""
    code = (
        'import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n'
        'import small\n'
        'from tfep_bench import harness\n'
        'small.run(small.cell("mixed_maf_helix32.eval"))\n'
        'print(harness.banned_modules())\n'
        % (str(BENCH.parent), str(BENCH / 'tests')))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, env={'PATH': '/usr/bin'})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'
