"""The dense-family checks of ``test_torch_dense_llama3.py`` on the
phi3_mini_3_8b smoke config (head_dim 12, G = 1 (four kv heads))."""
import pytest

from test_torch_dense_llama3 import *  # noqa: F401,F403  (the same tests)
from test_torch_dense_llama3 import make_model
from _torch_threads import _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def model():
    return make_model("phi3_mini_3_8b")
