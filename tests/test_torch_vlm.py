"""The model checks of ``test_torch_audio_vlm.py`` on the vlm family's
smoke config (phi3_vision_4_2b: 16 image patches prepended to the text,
prefilled by embedding; its engine serves text prompts)."""
import pytest

from test_torch_audio_vlm import (  # noqa: F401  (the same tests)
    make_model, test_allocations_identical_given_reference_numbers,
    test_embed_argument_on_the_paged_route, test_engine_streams_match_jax_engine,
    test_forward_and_loss_match, test_prefill_matches_forward_and_reference,
    test_qtensors_byte_identical, test_traces_match)
from _torch_threads import _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def model():
    return make_model("phi3_vision_4_2b")
