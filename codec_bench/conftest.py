"""Test set-up of the benchmark's own tests (``codec_bench/tests``).

Tests that need a CUDA card carry the ``card`` marker and take the
``cuda_card`` fixture, which skips them where there is none: the decision is
made when the test runs, never while a module is imported.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
    import torch

    # several workers share the host: one thread each for the plain
    # versions of the kernels
    torch.set_num_threads(1)


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return "cuda"
