"""Tests of the benchmark's harness.  Those that need an NVIDIA card
carry the ``chip`` marker and take the ``cuda_device`` fixture, which
skips them where there is none; run them on a card with
``python -m pytest -m chip saturn_bench``."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture
def no_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The CPU runs here are tiny: one thread each keeps the test
    workers from crowding each other's cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
