"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from the
root of the checkout. They run on the CPU at tiny sizes; those marked
``chip`` need a card, decide so inside the test, and skip without one (run
them on the card with ``python -m pytest portbench/tests -q -m chip``)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """The card, or a skip with the reason."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
