"""One fixture for the tests of swimm_tpu_torch (not a test module): torch's
CPU ops on one intra-op thread for the length of each test module that
imports it.

The suite runs in several worker processes on a machine with few cores.
With a thread per core in every worker, the plain PyTorch scorers (many
small ops, each a parallel region) ran many times slower than alone: on
8 cores with six workers the whole suite took 805 s, and 330 s with
this fixture. Results do not depend on the thread count: the scorers
compute integers."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
