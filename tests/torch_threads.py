"""torch on one intra-op thread for a test module's tests: importing
:func:`one_thread` into the module (``from tests.torch_threads import
one_thread  # noqa: F401``) applies it. The suite runs six pytest
workers on eight cores, where torch's default of one thread a core
oversubscribes them; the port's small CPU cases gain nothing from more
threads (the spawned test worlds run with ``OMP_NUM_THREADS=1``)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
