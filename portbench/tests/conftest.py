"""The benchmark's tests: CPU tests at tiny sizes, and `card` tests that
run a cell on a CUDA card (each skips, from inside the test, where there
is none):

    python -m pytest portbench/tests -q
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test where torch sees no CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs a cell on the card")
    return "cuda"
