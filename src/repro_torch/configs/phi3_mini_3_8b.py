"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064. RoPE SwiGLU. [arXiv:2404.14219]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="phi3_mini_3_8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064, act="swiglu",
)

SMOKE = ModelConfig(
    name="phi3_mini_3_8b_smoke", family="dense",
    num_layers=2, d_model=48, num_heads=4, num_kv_heads=4, head_dim=12,
    d_ff=96, vocab_size=256, act="swiglu", attn_chunk=32, dtype="float32",
)
