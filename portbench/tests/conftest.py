"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of a checkout.  Tests marked ``cuda`` need a card and skip without
one (decided in the ``card`` fixture, never at import)."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE.parents[1]))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
