"""pytest settings of the benchmark's own tests (``port_bench/tests``):
the ``gpu`` marker, for tests that need a CUDA card, and the fixture
that decides, when a test runs, whether one is there."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA CUDA card; skips without one")


@pytest.fixture
def cuda():
    """The card's device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
