"""One torch CPU thread for a port test module.

The tier-1 run puts six pytest workers on the machine's cores. With torch's
default pool (a thread per core) in each worker, the cores are
oversubscribed several times over and the port's small CPU cases spend
most of their time waiting on one another's threads: the port's test files
took 2.5 times longer in all under the six workers than with one thread
each. A module imports :func:`one_torch_thread` to run its tests on one
thread; the pool size is restored after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
