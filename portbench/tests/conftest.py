"""The benchmark's CPU tests: ``python -m pytest portbench/tests``.

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which decides inside the test whether a card is there and skips
without one; on the chip: ``python -m pytest portbench/tests -m card``.
"""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
