"""Guards of the port: it imports no JAX and nothing of ``tfep_tpu``, and
its entry points never quietly fall back to the CPU."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.nn.conditioners.made import MADE
from tfep_tpu_torch.nn.dynamics import EGNNDynamics, MaskedVelocityDynamics
from tfep_tpu_torch.nn.embeddings import (
    BehlerParrinelloRadialExpansion, GaussianBasisExpansion,
)
from tfep_tpu_torch.nn.flows import ContinuousFlow, MAF, SequentialFlow
from tfep_tpu_torch.nn.masked import MaskedLinear
from tfep_tpu_torch.nn.transformers import (
    NeuralSplineTransformer, VolumePreservingShiftTransformer,
)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / 'tfep_tpu_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py']


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split('.')[0])
    return roots


@pytest.mark.parametrize('path', PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert not _imported_roots(path) & {'jax', 'jaxlib', 'tfep_tpu'}


@pytest.fixture
def no_card(monkeypatch):
    """The CPU-only view, also where a card is present."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


@pytest.mark.parametrize('entry_point', [
    lambda: resolve_device(),
    lambda: MAF.create(torch.Generator(), np.arange(3)),
    lambda: SequentialFlow.create(),
    lambda: NeuralSplineTransformer(-1.0, 1.0, 4),
    lambda: VolumePreservingShiftTransformer(),
    lambda: MADE(torch.Generator(), np.arange(3), np.arange(3)),
    lambda: MaskedLinear(torch.Generator(), 3, 4),
    lambda: GaussianBasisExpansion([0.0, 1.0], [1.0, 1.0]),
    lambda: BehlerParrinelloRadialExpansion(1.0, [0.0, 1.0], [1.0, 1.0]),
    lambda: EGNNDynamics.create(torch.Generator(), [0, 1], 3.0),
    lambda: EGNNDynamics.create(torch.Generator(), [0, 1], 3.0,
                                pairwise='fused'),
    lambda: MaskedVelocityDynamics.create(torch.nn.Identity(), [0], 3),
    lambda: ContinuousFlow.create(torch.nn.Identity()),
])
def test_entry_points_without_device_raise(no_card, entry_point):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        entry_point()


def test_explicit_cpu_device(no_card):
    assert resolve_device('cpu') == torch.device('cpu')
    layer = MaskedLinear(torch.Generator(), 3, 4, device='cpu')
    assert layer.weight.device.type == 'cpu'


def test_explicit_cpu_device_cnf(no_card):
    dynamics = EGNNDynamics.create(torch.Generator(), [0, 1], 3.0,
                                   device='cpu', pairwise='fused')
    flow = ContinuousFlow.create(dynamics, device='cpu')
    assert all(p.device.type == 'cpu' for p in flow.parameters())


def test_compute_dtype_is_not_ported():
    with pytest.raises(NotImplementedError):
        MaskedLinear(torch.Generator(), 3, 4, device='cpu',
                     compute_dtype='bfloat16')
