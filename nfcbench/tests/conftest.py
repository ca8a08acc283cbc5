"""nfcbench's own tests.  The ``cuda`` marker is for tests that need a
card: they decide inside the ``cuda_device`` fixture, never at import,
so every worker collects the same tests."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (runs the benchmark's entries)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"


@pytest.fixture
def engines(monkeypatch):
    """The farm's device engines replaced by the all-triggers stand-in."""
    from nfcbench.tests import standin

    with standin.engines(monkeypatch):
        yield
