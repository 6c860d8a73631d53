"""One intra-op thread for the port's CPU tests.

The test runner spreads the files over several worker processes, and
torch's default intra-op pool gives every worker a thread for each core.
The workers then oversubscribe the cores, and small ops spend their time
spin-waiting for one another's threads (a 2 s training loop took 426 s
with six such workers side by side, 2 s with one thread each).  A test
module imports ``one_torch_thread``; it is autouse, so every test in the
module runs with one thread, and the module's end restores the count.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
