"""One intra-op thread for the port's CPU tests.

The suite runs in several worker processes (`-n 6 --dist loadfile`), and
each process's torch starts an OpenMP pool as wide as the machine, so the
workers' threads oversubscribe the cores and wait on each other; the
tensors of these tests are tiny, and gain nothing from the threads.  A port
test file imports the fixture below (`from torch_threads import
one_torch_thread  # noqa: F401`), which then runs before every other
fixture of the file.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's tests with torch on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
