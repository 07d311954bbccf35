"""One torch thread for a test module on the CPU.

The suite runs under pytest-xdist with several workers, each a process
whose torch would use every core for its intra-op threads.  The port's CPU
tests run small tensors, whose ops gain nothing from more threads, and
with every worker spinning a thread a core the cores are oversubscribed:
a test that takes 13 s alone took over 200 s beside two other workers.
A module that imports `one_torch_thread` runs its tests with one intra-op
thread and restores the count after it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch.set_num_threads(1) for the module's tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
