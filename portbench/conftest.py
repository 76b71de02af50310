"""The benchmark's own tests (portbench/test_portbench_*.py):

    python3 -m pytest portbench -q

Tests marked `cuda` need an NVIDIA card and skip elsewhere; whether a
card is present is decided inside the `card` fixture, never at import.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where "
        "torch.cuda.is_available() is False")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs only on the chip")
    return "cuda"
