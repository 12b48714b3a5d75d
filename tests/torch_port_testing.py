"""Shared set-up of the port's CPU tests (``tests/test_torch_*.py``)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's torch ops on one intra-op thread, and restore the count
    after it.

    The suite runs in several pytest-xdist workers at once. At torch's default
    of one thread per core in every worker, the tiny ops of these tests spend
    most of their time in threads that contend for the cores, theirs and the
    other workers'.
    """
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
