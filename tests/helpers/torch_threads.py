"""One torch intra-op thread while a port test module runs.

The tier-1 run puts six pytest workers on the CPU at once; torch's default
intra-op pool (one thread per core) in each of them, beside XLA's, makes
the workers fight for the cores.  A port test module imports
`one_torch_thread` (autouse, module scope): its tests run torch on one
thread, and the count is restored when the module is done.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
