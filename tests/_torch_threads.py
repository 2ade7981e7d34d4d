"""One intra-op thread for PyTorch while a port test module runs.

The suite runs several pytest workers on one machine; each PyTorch process
would otherwise start a thread per core for every parallel operation, and
the oversubscribed cores make the many small operations of the port's
build and out-of-core paths over ten times slower. Import the fixture into
a test module (``from _torch_threads import one_torch_thread``) to apply
it to that module's tests; the previous setting is restored afterwards.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
