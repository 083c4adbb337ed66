"""One intra-op thread for each CPU test of the port.

The port's CPU tests run many small ops. Under `-n 6` each worker's torch
takes a thread a core by default, and every parallel region then waits on
threads the other workers keep off the cores: a zamba2 test ran 30 times
slower than alone, and the port's suite ran 5.7 times longer (1256 s
against 218 s single-threaded, the same 640 tests passing). A module
imports the fixture to take it:

  from torch_threads import one_thread  # noqa: F401

The thread count is restored after each test, so other modules are not
touched.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
