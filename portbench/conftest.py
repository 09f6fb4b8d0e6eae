"""pytest settings of the benchmark's own tests (collected from the repo root)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips where there is none (decided in a fixture)")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on the card only")
    return torch.device("cuda", torch.cuda.current_device())
