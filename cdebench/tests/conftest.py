"""Shared fixtures of the benchmark's CPU tests.

Run from the root of the repository: ``python -m pytest cdebench/tests -q``.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def card():
    """A CUDA device, or a skip: decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark's runs measure only there")
    return torch.device("cuda", 0)
