"""Shared fixtures of the port's CPU tests (tests/test_torch_*.py)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: the plain CPU blend steps over
    small tensors, and beside the suite's other workers more threads only
    contend. Import it into a test module to apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
