"""pytest settings of the benchmark's own tests (``python -m pytest
bench/tests``): the source roots on the path, the ``card`` marker, and
the ``card`` fixture that skips a test where no CUDA device is visible
(decided when the test runs, never at import)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips on the CPU)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; none is visible")
    return torch.device("cuda", 0)
