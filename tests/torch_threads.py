"""A module-scoped autouse fixture for the port's CPU tests.

The suite runs in several worker processes at once, and torch's CPU ops
default to one thread per core in each of them; the oversubscribed thread
pools then spend most of their time waiting on each other. Import the
fixture into a test module to run that module's torch ops on two threads:

    from torch_threads import two_torch_threads  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
