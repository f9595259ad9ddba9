"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (kv=16) d_ff=1024/expert,
MoE 64 experts top-8, vocab=50304. [arXiv:2409.02060]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="olmoe_1b_7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304, act="swiglu",
    num_experts=64, top_k=8,
)

SMOKE = ModelConfig(
    name="olmoe_1b_7b_smoke", family="moe",
    num_layers=2, d_model=48, num_heads=4, num_kv_heads=4, head_dim=12,
    d_ff=32, vocab_size=256, act="swiglu",
    num_experts=8, top_k=2, attn_chunk=32, dtype="float32",
)
