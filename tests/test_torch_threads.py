"""The torch test modules' thread setting.

The suite runs in several processes at once (``pytest -n``): torch's
thread pool in each, one thread a core, would oversubscribe the cores (its
workers spin while they wait), which made small-tensor tests 20-40x
slower. A module imports ``one_torch_thread`` from here to run its torch
work on one thread.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_a_module_runs_on_one_thread():
    assert torch.get_num_threads() == 1
