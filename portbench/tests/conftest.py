"""The benchmark's own tests: `python -m pytest portbench/tests -q`.
Tests marked `chip` need a CUDA card and skip inside the `card` fixture
where there is none (run them on the card:
`python3 -m pytest portbench/tests -q -m chip`)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped in the `card` fixture "
        "where torch sees none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
