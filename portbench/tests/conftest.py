"""Fixtures of the benchmark's own tests: `card` skips a test without a
CUDA card (decided when the test runs, never at import), `cache` keeps
the data and datasets of the CPU runs of one test run."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture(scope="session")
def cache():
    return {}
