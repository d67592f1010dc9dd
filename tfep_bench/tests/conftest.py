"""The benchmark's CPU tests: the repository's root on the import path,
JAX kept out (nothing here imports it), small sizes."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when a test runs, never when a
    module is imported."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')
