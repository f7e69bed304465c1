"""An autouse fixture for the port's CPU test files: each test module runs
torch on one intra-op thread (its module-scoped fixtures too), the thread
count restored after it.

The port's tests run small convolutions and train steps, where torch's
default of one thread per core costs more in synchronisation than it
gains, and the suite runs several pytest workers on the same cores. A
test module takes the fixture with ``from torch_port_threads import
one_torch_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
