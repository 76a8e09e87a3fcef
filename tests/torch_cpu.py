"""CPU settings of the port's tests (tests/test_torch_*.py).

The suite runs in several pytest-xdist worker processes at once, and
torch's default of one intra-op thread a core then oversubscribes the
host several times over: an OpenMP region waits for threads that other
workers' regions hold, and a test runs many times slower than alone.
Each port test module imports ``one_torch_thread``, an autouse fixture
that runs the module with one torch thread and restores the count after.
Results do not depend on it: tests that compare against worker
subprocesses already run both sides with one thread.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
