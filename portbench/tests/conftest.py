"""Fixtures of the benchmark's own tests. Tests that need a CUDA card are
marked ``cuda`` and decide inside the ``card`` fixture, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_root(tmp_path):
    from portbench.tests import tiny

    return tiny.make_root(tmp_path)
