"""Torch on one CPU thread for a test module, as a fixture.

The port's CPU tests that emulate a kernel's sums make thousands of small
torch operations. The other test workers run beside them, and on an
oversubscribed host torch's thread pool makes each small operation wait for
all its threads: one case took 59 s against 0.5 s beside ten busy
processes. A module takes the fixture with::

    from _torch_threads import one_thread  # noqa: F401
    pytestmark = pytest.mark.usefixtures("one_thread")
"""

import pytest
import torch


@pytest.fixture(scope="module")
def one_thread():
    """Torch on one CPU thread for the module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
