"""pytest settings of the benchmark's own tests (portbench/tests).

The `card` marker: a test that needs a CUDA device.  Whether one is there
is decided inside the `cuda_device` fixture, never while a module is
imported.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"
