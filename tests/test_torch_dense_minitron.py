"""The dense-family checks of ``test_torch_dense_llama3.py`` on the
minitron_4b smoke config (relu2, a single kv head, G = 3)."""
import pytest

from test_torch_dense_llama3 import *  # noqa: F401,F403  (the same tests)
from test_torch_dense_llama3 import make_model
from _torch_threads import _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def model():
    return make_model("minitron_4b")
