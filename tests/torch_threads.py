"""One PyTorch intra-op thread for a test module's tests (an autouse
fixture a test module imports).

The tier-1 run puts six pytest workers on the machine's cores. The port's
CPU tests run many small tensor ops; with PyTorch's default of one
OpenMP thread a core in each worker, the idle threads spin between ops and
the workers crowd each other out (a file that takes 20 s alone took 170 s
beside five others). One thread each computes the same numbers (the
tests compare to references that do not depend on the thread count) in
the same time alone.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
