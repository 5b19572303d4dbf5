"""CPU tests of the benchmark. Tests that need a CUDA card carry the
`card` marker and skip without one (decided inside the test)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    import torch
    torch.set_num_threads(2)
    yield


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
