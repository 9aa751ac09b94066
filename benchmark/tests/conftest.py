"""The benchmark's own tests: `python -m pytest benchmark/tests` from the
root of the checkout. They run on the CPU at small sizes; a test marked
`card` needs a CUDA device and skips without one (decided in its
fixture, never at import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
