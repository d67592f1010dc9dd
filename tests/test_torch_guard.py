"""Guards of the port: it imports no JAX, nothing of ``tfep_tpu``, no
``networkx`` and no ``MDAnalysis``, its native trajectory decoder is
built from its own copy of the C++ source, and its entry points never
quietly fall back to the CPU."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from tfep_tpu_torch.analysis import bootstrap, fep_estimator
from tfep_tpu_torch.app import (
    CartesianMAFMap, ContinuousEGNNMap, MixedMAFMap, TFEPMapBase,
)
from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.io.topology import Topology
from tfep_tpu_torch.io import native
from tfep_tpu_torch.io.traj import System
from tfep_tpu_torch.nn.conditioners.made import MADE
from tfep_tpu_torch.nn.dynamics import EGNNDynamics, MaskedVelocityDynamics
from tfep_tpu_torch.nn.embeddings import (
    BehlerParrinelloRadialExpansion, FlipInvariantEmbedding,
    GaussianBasisExpansion, MixedEmbedding, PeriodicEmbedding,
)
from tfep_tpu_torch.nn.graph import FixedGraph
from tfep_tpu_torch.nn.flows import (
    CartesianToMixedFlow, CenteredCentroidFlow, ContinuousFlow, MAF,
    OrientedFlow, PartialFlow, PCAWhitenedFlow, SequentialFlow,
)
from tfep_tpu_torch.nn.masked import MaskedLinear
from tfep_tpu_torch.nn.transformers import (
    MixedTransformer, NeuralSplineTransformer,
    VolumePreservingShiftTransformer,
)
from tfep_tpu_torch.ops.zmatrix import PlacementSchedule
from tfep_tpu_torch.units import ureg

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / 'tfep_tpu_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py']


def _map_args():
    system = System(Topology(names=['C0', 'C1', 'C2']), np.zeros((4, 3, 3)))
    return dict(potential_energy_func=lambda x: x.sum(-1),
                temperature=300.0 * ureg.kelvin, system=system)


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


@pytest.mark.parametrize('path', PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_networkx(path):
    """The machine with the card has no networkx: the Z-matrix builder
    walks the bond graph with the port's own helpers."""
    assert 'networkx' not in _imported_roots(path)


@pytest.mark.parametrize('path', PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_mdanalysis(path):
    """``System.from_universe`` is duck-typed: MDAnalysis is never
    imported."""
    assert 'MDAnalysis' not in _imported_roots(path)


def test_native_source_is_the_ports_own():
    """The loader compiles ``tfep_tpu_torch/native/trajio.cpp`` into
    ``build/native/``, never the JAX package's copy."""
    assert native.SOURCE == ROOT / 'tfep_tpu_torch' / 'native' / 'trajio.cpp'
    assert native.SOURCE.is_file()
    assert sorted(p.name for p in (ROOT / 'tfep_tpu_torch' / 'native')
                  .iterdir()) == ['trajio.cpp']
    assert native.BUILD_DIR == ROOT / 'build' / 'native'
    assert 'tfep_tpu/' not in native.SOURCE.read_text().replace(
        'tfep_tpu_torch/', '')


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
    lambda: PartialFlow.create(torch.nn.Identity(), [0], 3),
    lambda: CenteredCentroidFlow.create(torch.nn.Identity(), 3, 6),
    lambda: OrientedFlow.create(torch.nn.Identity(), 9),
    lambda: PCAWhitenedFlow.create(
        torch.nn.Identity(), np.random.default_rng(0).normal(size=(8, 3))),
    lambda: TFEPMapBase(**_map_args()),
    lambda: CartesianMAFMap(**_map_args(), n_maf_layers=2),
    lambda: ContinuousEGNNMap(**_map_args()),
    lambda: MixedMAFMap(**_map_args()),
    lambda: FixedGraph(),
    lambda: fep_estimator(np.zeros(3)),
    lambda: bootstrap(np.zeros(3), fep_estimator, n_resamples=2),
    lambda: PeriodicEmbedding(3, [0.0, 1.0]),
    lambda: FlipInvariantEmbedding(torch.Generator(), 4, 2),
    lambda: MixedEmbedding(3, [torch.nn.Identity()], [[0]]),
    lambda: MixedTransformer([torch.nn.Identity()] * 2, [[0], [1]]),
    lambda: PlacementSchedule([[3, 0, 1, 2]], 4),
    lambda: CartesianToMixedFlow.create(None, [0, 1, 2], [[3, 0, 1, 2]],
                                        [0, 1, 2], [True] * 3),
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


def test_explicit_cpu_device_map(no_card):
    tfep_map = CartesianMAFMap(**_map_args(), n_maf_layers=2, device='cpu',
                               tfep_logger_dir_path=None)
    tfep_map.setup()
    assert all(p.device.type == 'cpu' for p in tfep_map.flow.parameters())


def test_compute_dtype_is_not_ported():
    with pytest.raises(NotImplementedError):
        MaskedLinear(torch.Generator(), 3, 4, device='cpu',
                     compute_dtype='bfloat16')
