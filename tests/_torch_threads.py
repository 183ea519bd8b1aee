"""One torch intra-op thread for the port's test modules.

Each ``tests/test_torch_*.py`` imports ``one_torch_thread``, a
module-scoped autouse fixture. In the suite's xdist workers (``-n 6``
on an 8-core CPU host) torch's intra-op thread pool spins against the
other workers' processes: a port-only test of
``tests/test_torch_train_step.py`` took 20 s there instead of 0.3 s
alone, and the four slowest port files 325 worker-seconds instead of
208 with one thread (``-n 4``, the same host). The cases and their
results are the same; the count is restored after the module.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
