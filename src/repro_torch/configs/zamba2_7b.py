"""zamba2-7b [hybrid] — 81L d_model=3584, Mamba2 backbone (ssm_state=64)
with a SHARED attention+MLP block (32H kv=32, d_ff=14336) invoked every
6 Mamba2 layers, vocab=32000. Sub-quadratic backbone: runs long_500k.
[arXiv:2411.15242]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="zamba2_7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000, act="swiglu",
    ssm_state=64, ssm_headdim=64, ssm_expand=2, conv_width=4,
    attn_period=6,
    skip_shapes=(),  # hybrid: long_500k applies
)

SMOKE = ModelConfig(
    name="zamba2_7b_smoke", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, act="swiglu",
    ssm_state=16, ssm_headdim=16, ssm_expand=2, conv_width=4, ssm_chunk=32,
    attn_period=2, attn_chunk=32, skip_shapes=(), dtype="float32",
)
