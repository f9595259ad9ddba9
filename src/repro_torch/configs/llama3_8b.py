"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256. GQA, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="llama3_8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, act="swiglu", rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama3_8b_smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, act="swiglu", rope_theta=500000.0,
    attn_chunk=32, dtype="float32",
)
