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
from tfep_tpu_torch.parallel.distributed import initialize
from tfep_tpu_torch.parallel.sharding import make_mesh
from tfep_tpu_torch.units import ureg

ROOT = Path(__file__).resolve().parents[1]
# The port, its smoke run and the test workers that its multi-process
# tests start (which must run without JAX).
PORT_FILES = sorted((ROOT / 'tfep_tpu_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py'] + sorted((ROOT / 'tests').glob('torch_*.py'))


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
    lambda: make_mesh(),
    lambda: initialize(world_size=2, rank=0),
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
    """``compute_dtype`` is ported: the layer builds, keeps its weights in
    the storage dtype and returns it."""
    layer = MaskedLinear(torch.Generator(), 3, 4, device='cpu',
                         compute_dtype='bfloat16')
    assert layer.compute_dtype is torch.bfloat16
    assert layer.weight.dtype == torch.float32
    assert layer(torch.ones(2, 3)).dtype == torch.float32


# --------------------------------------------------------------------------
# The engine bridge: optional engines, spawn-safe imports.
# --------------------------------------------------------------------------

ENGINES = {'ase', 'openmm', 'psi4', 'tblite'}
ENGINE_FILES = sorted((ROOT / 'tfep_tpu_torch' / 'potentials').glob('*.py')
                      ) + sorted((ROOT / 'tfep_tpu_torch' / 'parallel')
                                 .glob('*.py'))


def _guarded_engine_imports(path):
    """Each import of an engine package: ``(line, how)``, where ``how`` is
    'try' (in a ``try`` whose handlers catch ImportError), 'function'
    (inside a function body) or 'module' (neither)."""
    found = []

    def visit(node, how):
        for child in ast.iter_child_nodes(node):
            child_how = how
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_how = 'function'
            elif isinstance(child, ast.Try) and how == 'module' and any(
                    isinstance(h.type, ast.Name)
                    and h.type.id in ('ImportError', 'ModuleNotFoundError')
                    for h in child.handlers):
                for stmt in child.body:
                    visit_stmt(stmt, 'try')
                for part in child.handlers + child.orelse + child.finalbody:
                    visit_stmt(part, how)
                continue
            visit_stmt(child, child_how)

    def visit_stmt(node, how):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        if any(n.split('.')[0] in ENGINES for n in names):
            found.append((node.lineno, how))
        visit(node, how)

    visit(ast.parse(path.read_text(), str(path)), 'module')
    return found


@pytest.mark.parametrize('path', ENGINE_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_engines_imported_only_when_guarded(path):
    assert all(how != 'module' for _, how in _guarded_engine_imports(path))


def test_each_engine_wrapper_imports_its_engine_guarded():
    for name in ENGINES:
        found = _guarded_engine_imports(
            ROOT / 'tfep_tpu_torch' / 'potentials' / f'{name}.py')
        assert found and all(how in ('try', 'function') for _, how in found)


def test_potentials_import_without_engines_cuda_or_jax():
    """``import tfep_tpu_torch.potentials`` (and ``parallel`` and
    ``utils.plumed``) succeeds in a fresh interpreter where the four
    engines cannot be imported, and neither initializes CUDA nor imports
    JAX: a spawned pool worker does the same imports."""
    import os
    import subprocess
    import sys
    script = (
        'import importlib.abc, sys\n'
        'class Block(importlib.abc.MetaPathFinder):\n'
        '    def find_spec(self, name, path, target=None):\n'
        f'        if name.split(".")[0] in {sorted(ENGINES)!r}:\n'
        '            raise ImportError(name)\n'
        'sys.meta_path.insert(0, Block())\n'
        'import tfep_tpu_torch.potentials as p, tfep_tpu_torch.parallel\n'
        'import tfep_tpu_torch.utils.plumed, torch\n'
        'assert not (p.ase.ASE_INSTALLED or p.openmm.OPENMM_INSTALLED\n'
        '            or p.psi4.PSI4_INSTALLED or p.tblite.TBLITE_INSTALLED)\n'
        'assert not torch.cuda.is_initialized()\n'
        'assert not any(m == "jax" or m.startswith(("jax.", "tfep_tpu."))\n'
        '               or m == "tfep_tpu" for m in sys.modules)\n'
        'print("ok")\n')
    result = subprocess.run([sys.executable, '-c', script], cwd=ROOT,
                            capture_output=True, text=True, timeout=120,
                            env={**os.environ, 'PYTHONPATH': str(ROOT)})
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == 'ok'
