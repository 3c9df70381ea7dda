"""One torch intra-op thread for each test module of the port.

The suite runs in several worker processes at once. Torch's CPU ops start
one OpenMP thread per core in every process, and the workers' threads then
spin against each other: six port and reference test files took 331 s with
6 workers on an 8-core CPU at the default, 97 s with one thread each. The
port's CPU work is many small ops, which one thread runs about as fast.
Import the fixture into a test module to apply it there.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
