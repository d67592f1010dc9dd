"""The plain references against the program in float64 on the CPU, through
the harness's own runs: the same frames and weights, the program's first
steps through ``Trainer.fit`` (or its evaluation passes) against the
reference's."""

import pytest
import torch

import small
from tfep_bench import harness

# float64 on both sides: the gaps are round-off of some 1e-12 at these
# sizes; 1e-9 leaves room and fails any difference of mathematics.
TOL = 1e-9


@pytest.mark.parametrize('name', ['mixed_maf_helix32.train',
                                  'mixed_maf_helix32.eval',
                                  'cnf_egnn32.train'])
def test_program_matches_reference_in_float64(name):
    result, rows, record = small.run(small.cell(name))
    gaps = {n: v for n, v, _ in rows}
    assert record['steps'] >= 1
    for gap, value in gaps.items():
        if gap != 'misplaced':
            assert value < TOL, (gap, gaps)
    assert gaps.get('misplaced', 0) == 0
    assert result['correct'] is True


def test_mixed_z_matrix_is_the_programs():
    from tfep_bench.harness import BENCH, load
    c = small.cell('mixed_maf_helix32.train')
    ref = load(BENCH / 'reference' / 'mixed_maf_helix32.py')
    frames = c.adapter.frames(c.cfg, 64, 3, 'cpu')
    tmap = c.adapter.build_map(c.cfg, c.traffic, frames.numpy(), 'cpu')
    tmap.setup()
    layout = ref.structure(c.cfg).layout
    assert tmap.flow.z_matrix.tolist() == layout.z.tolist()
    assert tmap.flow.cartesian_atom_indices.tolist() == layout.frame


def test_full_size_structure_matches_the_configuration():
    """The reference's sizes at the cell's configuration: MADE 125 -> 525
    -> 525 -> 2219 and 9,076,578 parameters, 15 placement levels' worth of
    Z-matrix rows (29)."""
    import json
    ref = harness.load(harness.BENCH / 'reference' / 'mixed_maf_helix32.py')
    cfg = json.loads((harness.BENCH / 'configs' / 'mixed_maf_helix32.json')
                     .read_text())
    spec = ref.structure(cfg)
    widths = [len(d) for d in spec.layers[0]['degrees']]
    assert widths == cfg['made']
    n = sum(int(torch.tensor(shape).prod())
            for _, shape, _, _ in ref.weight_spec(spec))
    assert n == cfg['n_parameters']
    assert len(spec.layout.z) == 29


def test_cnf_structure_matches_the_configuration():
    import json
    ref = harness.load(harness.BENCH / 'reference' / 'cnf_egnn32.py')
    cfg = json.loads((harness.BENCH / 'configs' / 'cnf_egnn32.json')
                     .read_text())
    n = sum(int(torch.tensor(shape).prod())
            for _, shape, _, _ in ref.weight_spec(ref.structure(cfg)))
    # The program's count holds two size-0 slots per Gaussian expansion.
    assert n == cfg['n_parameters']
