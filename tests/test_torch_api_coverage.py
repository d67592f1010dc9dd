"""Every public name of ``tfep_tpu`` has its counterpart in the port.

Each ``tfep_tpu`` module is matched with the module at the same relative
path in ``tfep_tpu_torch``; its public names are its ``__all__``, or else
the functions and classes defined in it. The few places where the port
replaces a module or a name are listed in ``EXCLUDED`` and ``RENAMED``,
each with its reason.
"""

import importlib
import inspect
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import tfep_tpu

ROOT = Path(__file__).resolve().parents[1]

# JAX module -> why the port has no module of that name.
EXCLUDED = {
    'tfep_tpu.nn.module': 'the pytree Module is replaced by torch.nn.Module',
    'tfep_tpu.ops.pallas': 'the Pallas kernels map to ops/spline.py and '
                           'ops/egnn.py (MODULE_MAP)',
}

# JAX module -> the port's module that holds its names.
MODULE_MAP = {
    'tfep_tpu.ops.pallas.spline': 'tfep_tpu_torch.ops.spline',
    'tfep_tpu.ops.pallas.egnn': 'tfep_tpu_torch.ops.egnn',
}

# (JAX module, name) -> the port's names that replace it.
RENAMED = {
    ('tfep_tpu.ops.pallas.egnn', 'fused_egnn_pairwise'):
        # The primal and the dual pass are two entry points of the port.
        ('egnn_pairwise', 'egnn_pairwise_jvp'),
}

JAX_MODULES = sorted(
    info.name for info in pkgutil.walk_packages(tfep_tpu.__path__,
                                                'tfep_tpu.')
    if info.name not in EXCLUDED)


def public_names(module):
    if hasattr(module, '__all__'):
        return list(module.__all__)
    return [name for name, obj in vars(module).items()
            if not name.startswith('_')
            and (inspect.isfunction(obj) or inspect.isclass(obj))
            and obj.__module__ == module.__name__]


def port_name(jax_name):
    return MODULE_MAP.get(jax_name,
                          'tfep_tpu_torch' + jax_name[len('tfep_tpu'):])


@pytest.mark.parametrize('jax_name', JAX_MODULES)
def test_public_names_have_counterparts(jax_name):
    jax_module = importlib.import_module(jax_name)
    port = importlib.import_module(port_name(jax_name))
    missing = []
    for name in public_names(jax_module):
        expected = RENAMED.get((jax_name, name), (name,))
        missing += [n for n in expected if not hasattr(port, n)]
    assert not missing, f'{port.__name__} lacks {missing}'


def test_exclusions_are_real():
    """Each listed exclusion and rename names something JAX has."""
    for name in list(EXCLUDED) + list(MODULE_MAP):
        importlib.import_module(name)
    for (module, name) in RENAMED:
        assert name in public_names(importlib.import_module(module))


def test_top_level_exposes_every_subpackage():
    """``import tfep_tpu_torch`` alone, in a fresh process, exposes each
    subpackage that ``import tfep_tpu`` does."""
    subpackages = sorted(
        info.name for info in pkgutil.iter_modules(tfep_tpu.__path__)
        if info.ispkg and hasattr(tfep_tpu, info.name))
    assert {'analysis', 'parallel', 'potentials'} <= set(subpackages)
    script = ('import tfep_tpu_torch\n'
              f'for name in {subpackages!r}:\n'
              '    getattr(tfep_tpu_torch, name)\n')
    out = subprocess.run([sys.executable, '-c', script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize('value', [2.5, [1.0, 2.0], (3,), 'array', None])
def test_ensure_tensor_sequence_matches_jax(value):
    import numpy as np
    import torch

    from tfep_tpu.utils.misc import ensure_tensor_sequence as jax_fn
    from tfep_tpu_torch.utils.misc import ensure_tensor_sequence

    if value == 'array':
        value = np.arange(4.0).reshape(2, 2)[0]
    expected = jax_fn(value)
    actual = ensure_tensor_sequence(value)
    if value is None:
        assert actual is None and expected is None
        return
    assert actual.ndim == 1
    np.testing.assert_array_equal(actual.numpy(), np.asarray(expected))
    typed = ensure_tensor_sequence(value, dtype=torch.float64, device='cpu')
    assert typed.dtype == torch.float64 and typed.device.type == 'cpu'


def test_default_float():
    import torch

    from tfep_tpu_torch.nn.flows.flow import default_float

    assert default_float() == torch.get_default_dtype()
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        assert default_float() == torch.float64
    finally:
        torch.set_default_dtype(previous)
