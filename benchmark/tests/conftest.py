import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def one_thread():
    """One intra-op thread a test process: the small scenes' operations are
    too small to share, and several test workers would oversubscribe the
    cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
