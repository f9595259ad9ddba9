"""Port of ``repro.models``: the dense, MoE, ssm (Mamba2), hybrid
(Zamba2), audio and vlm families; the paper's CNN and U-Net testbeds in
``models.cnn`` and ``models.unet``."""
from repro_torch.models.transformer import (  # noqa: F401
    init_params, forward, loss_fn, vocab_padded, QATLevels)
from repro_torch.models.decode import (  # noqa: F401
    DecodeState, init_decode_state, decode_step, prefill)
from repro_torch.models.context import (  # noqa: F401
    Context, QATContext, TapContext, CollectContext)
