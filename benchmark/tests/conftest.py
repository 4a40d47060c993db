"""Tests of the benchmark harness.  Run on the CPU with
``python -m pytest benchmark/tests -q``; the tests marked ``chip`` need a
CUDA card and run on it with ``python -m pytest benchmark/tests -m chip``."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
