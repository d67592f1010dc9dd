"""Shared helpers of the port's tests (``tests/test_torch_*.py``).

Each port test builds the ``tfep_tpu`` object and its ``tfep_tpu_torch``
counterpart, carries the JAX weights across with
:func:`tfep_tpu_torch.convert.load_jax_state`, feeds both the same inputs
made with numpy from a seed, and compares in float64 on the CPU. Identity
initialization zeroes the output gains, so the JAX leaves are perturbed
with seeded noise first: otherwise both sides would compare the identity
with itself.
"""

import jax
import numpy as np
import torch

from tfep_tpu.nn.module import combine, partition
from tfep_tpu_torch.convert import load_jax_state

DTYPE = torch.float64
CPU = 'cpu'

# Forward values and gradients, as the JAX package's own tests hold them.
ATOL = 1e-10
GRAD_ATOL = 1e-9


def jax_state(module) -> dict:
    """``{keystr: numpy array}`` of every leaf of a JAX module."""
    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(module)[0]}


def perturb(module, seed: int, scale: float = 0.1):
    """The JAX module with seeded normal noise added to its trainable
    leaves (buffers and index tables are left alone)."""
    rng = np.random.default_rng(seed)
    trainable, frozen = partition(module)
    trainable = jax.tree_util.tree_map(
        lambda leaf: leaf + scale * rng.normal(size=np.shape(leaf)),
        trainable)
    return combine(trainable, frozen)


def carry(jax_module, torch_module):
    """Load the JAX module's leaves into its port; returns the port."""
    return load_jax_state(torch_module, jax_state(jax_module))


def t(a) -> torch.Tensor:
    """A numpy/JAX array as a float64 CPU tensor."""
    return torch.tensor(np.asarray(a), dtype=DTYPE)


def close(actual, expected, atol=ATOL):
    """Assert two arrays/tensors agree elementwise to ``atol``."""
    if isinstance(actual, torch.Tensor):
        actual = actual.detach().numpy()
    np.testing.assert_allclose(actual, np.asarray(expected), rtol=0,
                               atol=atol)


def torch_generator(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)
