"""Fixtures of the benchmark's tests. A test that needs the card takes
the ``cuda`` fixture, which skips where there is none (decided here, in
a fixture, never while a module is imported)."""

import pytest


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
