"""The module fixture that pins torch to one CPU thread.

A test module imports it (``from tests.torch_threads import
one_torch_thread  # noqa: F401``); being autouse and module-scoped, it
holds torch to one thread for that module's tests and restores the count
after them. The suite runs several worker processes on the machine's
cores, and torch's own thread pool in each of them makes the workers
contend: the convolutions of a parity test slow down many times over.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
