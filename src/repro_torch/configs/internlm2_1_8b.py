"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544. [arXiv:2403.17297]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="internlm2_1_8b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92544, act="swiglu",
)

SMOKE = ModelConfig(
    name="internlm2_1_8b_smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=384, act="swiglu", attn_chunk=32, dtype="float32",
)
