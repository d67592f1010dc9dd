"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, names,
units, lengths and files, and every cell finds each of its files by name."""

import json
import re

import pytest

from tfep_bench.harness import BENCH

ROOT = BENCH.parent
BENCHMARK = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
METRIC_KEYS = {'name', 'unit', 'better', 'source'}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s \
        and '\t' not in s


def test_top_level():
    assert set(BENCHMARK) == {'command', 'paths', 'run_seconds', 'configs',
                              'workloads', 'end_to_end', 'per_layer'}
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    assert BENCHMARK['command'] == ['python3', 'tfep_bench/run.py']
    assert all(text_ok(w) for w in BENCHMARK['command'])
    assert 1 <= len(BENCHMARK['paths']) <= 16
    for path in BENCHMARK['paths']:
        assert re.fullmatch(r'[A-Za-z0-9_./-]{1,200}', path)
        assert not path.startswith('/') and '..' not in path
        assert not path.endswith('_torch')
    rs = BENCHMARK['run_seconds']
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells, each run allowed run_seconds + 60 s and
    # each cell 180 s to compile, with 1,200 s spare, fits 43,200 s.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH.rglob('*'):
        if '__pycache__' in p.parts:
            continue
        assert re.fullmatch(r'[A-Za-z0-9_./-]+', str(p.relative_to(ROOT)))


def test_configs():
    names = [c['name'] for c in BENCHMARK['configs']]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    files = set()
    for c in BENCHMARK['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and text_ok(c['source'])
        assert text_ok(c['why']) and len(c['reduced']) <= 16
        assert all(NAME.match(k) for k in c['reduced'])
        assert c['file'] == f'tfep_bench/configs/{c["name"]}.json'
        assert c['file'] not in files
        files.add(c['file'])
        cfg = json.loads((ROOT / c['file']).read_text())
        assert cfg['reduced'] == c['reduced'] and cfg['name'] == c['name']
        assert cfg['dtype'] == 'float32' and cfg['allow_tf32'] is False
        for part in ('configs', 'reference', 'counts'):
            assert (BENCH / part / f'{c["name"]}.py').is_file()
        used = [w for w in BENCHMARK['workloads']
                if w['config'] == c['name']]
        assert used


def test_workloads():
    cells = BENCHMARK['workloads']
    assert 1 <= len(cells) <= 24
    assert len({w['name'] for w in cells}) == len(cells)
    assert len({(w['config'], w['traffic']) for w in cells}) == len(cells)
    assert sum(w['chips'] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert w['chips'] in (1, 4) and text_ok(w['why'])
        assert (BENCH / 'traffic' / f'{w["traffic"]}.json').is_file()
        limits = json.loads((BENCH / 'limits' / f'{w["name"]}.json')
                            .read_text())['limits']
        assert limits


def test_metrics():
    e2e, layer = BENCHMARK['end_to_end'], BENCHMARK['per_layer']
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    names = [m['name'] for m in e2e + layer]
    assert len(names) == len(set(names))
    cells = {w['name'] for w in BENCHMARK['workloads']}
    assert 'setup_s' in {m['name'] for m in e2e}
    for m in e2e:
        assert set(m) - {'workloads'} == METRIC_KEYS | {'bound'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
        assert (BENCH / 'end_to_end' / f'{m["name"]}.py').is_file()
    layers = {}
    for m in layer:
        assert set(m) - {'workloads'} == METRIC_KEYS | {'layer', 'moves'}
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert text_ok(m['layer'])
        layers.setdefault(m['name'].split('.')[0], set()).add(m['layer'])
        assert (BENCH / 'metrics' / f'{m["name"]}.py').is_file()
        moved = [e for e in e2e if e['name'] == m['moves']]
        assert moved
        for cell in m.get('workloads', cells):
            assert cell in cells
            assert cell in moved[0].get('workloads', cells)
        if m['name'].endswith('_roofline') or '_roofline.' in m['name'] \
                or 'mfu' in m['name']:
            assert m['unit'] == '%'
    for m in e2e + layer:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
    for cell in cells:
        mine = [m for m in e2e if cell in m.get('workloads', cells)]
        assert 'setup_s' in {m['name'] for m in mine} and len(mine) >= 2
        assert [m for m in layer if cell in m.get('workloads', cells)]


@pytest.mark.parametrize('name', [w['name'] for w in BENCHMARK['workloads']])
def test_every_cell_loads(name):
    from tfep_bench.harness import Cell
    cell = Cell(name)
    assert cell.traffic['entry'] in ('fit', 'evaluate')
    assert cell.end_to_end and cell.per_layer
