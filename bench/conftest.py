"""pytest settings of the benchmark's own tests (bench/tests/): one torch
thread a test process, and the `card` marker for tests that need a CUDA
device, which decide inside a fixture whether there is one."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (runs on the chip; skips "
        "elsewhere)")


@pytest.fixture
def card():
    """The CUDA device a `card` test runs on; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")
    return torch.device("cuda:0")
