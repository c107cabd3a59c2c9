"""The benchmark's tests: on the CPU, and `card` tests that need an NVIDIA
GPU and skip without one (decided inside the `card` fixture, never at
import).  Run them from the repo root:

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark's control runs on the card)")
    return torch.device("cuda", 0)
