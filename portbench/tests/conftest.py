import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
for p in (CHECKOUT, os.path.join(CHECKOUT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped where there is none"
    )


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def card_absent():
    """No card: a test of what a run does without one skips on the card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
