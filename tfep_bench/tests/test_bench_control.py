"""The control and the half-batch fault, put in the program's place, come
out not correct (``control.py`` reads them at the cells' own sizes on the
chip; here at sizes a test run holds)."""

import pytest
import torch

import small
from tfep_bench import checks, control
from tfep_bench.harness import Cell

TRAINING = ['mixed_maf_helix32.train', 'cnf_egnn32.train']


@pytest.mark.parametrize('name', TRAINING)
def test_half_of_each_batch_fails(name):
    cell = small.cell(name)
    gaps = control.readings(cell, small.SEED, torch.device('cpu'),
                            ['half'])['half']
    assert checks.judge(gaps, cell.limits)[0] is False


SMALL = {'mixed_maf_helix32.train': dict(frames=8192, batch=2048),
         'cnf_egnn32.train': dict(frames=1024, batch=256),
         'mixed_maf_helix32.eval': dict(frames=16384, eval_batch=8192)}


@pytest.mark.gpu
@pytest.mark.parametrize('name', list(SMALL))
def test_tf32_fails(card, name):
    """The configurations' widths, fewer frames: the reference in TF32
    against itself in float32 fails one of the cell's numbers."""
    cell = Cell(name, traffic=SMALL[name])
    gaps = control.readings(cell, small.SEED, card, ['tf32'])['tf32']
    assert checks.judge(gaps, cell.limits)[0] is False
