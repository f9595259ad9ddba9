"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (kv=16) d_ff=1408/expert,
2 shared + 64 routed experts top-6 (fine-grained), vocab=102400.
[arXiv:2401.06066]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="deepseek_moe_16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400, act="swiglu",
    num_experts=64, num_shared_experts=2, top_k=6,
)

SMOKE = ModelConfig(
    name="deepseek_moe_16b_smoke", family="moe",
    num_layers=2, d_model=48, num_heads=4, num_kv_heads=4, head_dim=12,
    d_ff=32, vocab_size=256, act="swiglu",
    num_experts=8, num_shared_experts=1, top_k=2, attn_chunk=32,
    dtype="float32",
)
