"""mamba2-130m [ssm] — 24L d_model=768 (attention-free), vocab=50280,
ssm_state=128. SSD (state-space duality). Sub-quadratic: runs long_500k.
[arXiv:2405.21060]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="mamba2_130m", family="ssm",
    num_layers=24, d_model=768, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, conv_width=4,
    skip_shapes=(),  # sub-quadratic decode: long_500k applies
)

SMOKE = ModelConfig(
    name="mamba2_130m_smoke", family="ssm",
    num_layers=2, d_model=64, d_ff=0, vocab_size=256,
    ssm_state=16, ssm_headdim=16, ssm_expand=2, conv_width=4, ssm_chunk=32,
    skip_shapes=(), dtype="float32",
)
