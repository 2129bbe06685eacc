"""One torch intra-op thread for a test module of the port: the suite
runs several workers on the machine's cores, where torch's thread pools
oversubscribe them and the port's many small ops slow down severalfold.
A module takes it by importing the fixture, after torch:

    torch = pytest.importorskip("torch")
    from torch_one_thread import one_torch_thread  # noqa: E402,F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
