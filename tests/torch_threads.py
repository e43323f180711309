"""One torch thread per test file of the port.

The tier-1 run puts each test file on one of six pytest-xdist workers
(`-n 6 --dist loadfile`).  Each worker's torch would open its own pool of
one thread per core for every CPU op, so six pools share eight cores, and
the port's tests, thousands of small ops each, spend their time waiting
on each other (on an 8-core host a refine test took 758 s so, 5 s alone).
A test file of the port imports this fixture; it runs the file's torch
work on one thread and puts the old count back after the file.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
