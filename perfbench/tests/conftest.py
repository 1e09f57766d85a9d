"""The benchmark's CPU tests: ``python -m pytest perfbench/tests``.

They import the benchmark (``perfbench``) and the program
(``src/repro_torch``) from this checkout.  A test that needs the card
takes the ``card`` fixture, which skips without CUDA; the decision is
made when the test runs, never at import.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (the "
                            "chip); skipped elsewhere")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
