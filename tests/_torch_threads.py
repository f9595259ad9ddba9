"""The port's test files run torch at one intra-op CPU thread.

The suite runs files in parallel worker processes, and several
multi-threaded torch pools on one host stall each other (a speculative
engine run took ~50x its one-process time under six workers at the
default). Each ``tests/test_torch_*.py`` imports the fixture below,
which pytest then uses for that module:

    from _torch_threads import _one_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module's tests, restored after them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
