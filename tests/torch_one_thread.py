"""torch on one CPU thread for the port's test files.

pytest-xdist runs the suite in several worker processes at once (tier-1
runs six), and torch's CPU ops take a thread per core in each of them
(OpenMP and MKL). The workers' threads then contend for the same cores,
and a test whose ops are small, as the port's reduced models' are,
spends most of its time waiting for them. Each ``tests/test_torch_*.py``
imports :func:`one_torch_thread`, an autouse fixture that runs the
file's tests on one torch thread and restores the count after: nothing
a test computes or compares changes, only the threads that compute it.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
