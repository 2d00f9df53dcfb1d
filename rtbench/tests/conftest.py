"""Settings of the benchmark's own tests: run them from the root of the
checkout with ``python -m pytest rtbench/tests``. They import neither JAX
nor the JAX package. The ``cuda`` tests need an NVIDIA GPU and skip
where there is none."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda:0")
