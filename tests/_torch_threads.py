"""Caps torch's intra-op threads while one of the PyTorch port's test modules
runs.

The tier-1 run puts 6 pytest-xdist workers on an 8-core machine, next to
XLA's own thread pool; torch's default of one intra-op thread per core then
oversubscribes the cores several times over and slows every worker, the one
that runs ``tests/models/test_all_models.py`` included.  Each port test
module imports ``cap_torch_threads``, a module-scoped autouse fixture, so
the cap holds only while that module's tests run and the old value comes
back after them: the workers' other test files keep torch's default.
"""

import pytest
import torch

# one thread: on an 8-core machine a whole tier-1 run took 1003 s with one
# and 1094 s with two
THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def cap_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)
