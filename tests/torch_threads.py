"""One torch intra-op thread for a test module's duration.

The suite runs six pytest workers on one host, each with torch's default
of one intra-op thread per core: their OpenMP threads then wait on each
other, and a tiny model's train steps ran an order of magnitude slower
inside the suite than alone. A module that does `from torch_threads import
one_intra_op_thread  # noqa: F401` runs its torch work on one thread and
restores the count after its last test. The computations and their
tolerances are the same; only how the CPU time is spread changes.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
