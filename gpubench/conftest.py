"""Settings of the benchmark's own tests (python -m pytest gpubench/): the
`cuda` marker, and the fixture that skips a card-only test without one."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test where torch sees no CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
