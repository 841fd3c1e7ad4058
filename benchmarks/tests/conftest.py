"""The benchmark's CPU tests: ``python -m pytest benchmarks/tests -q``.
Tests marked ``card`` run the benchmark on an NVIDIA card and skip
without one (decided inside a fixture, never at import)."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card")
    return torch.device("cuda", 0)
