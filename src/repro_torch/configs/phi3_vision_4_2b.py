"""phi-3-vision-4.2b [vlm] — phi3-mini backbone (32L d_model=3072 32H
kv=32 d_ff=8192 vocab=32064) + CLIP vision tower STUB: input_specs
provides precomputed patch embeddings prepended to the text sequence.
[hf:microsoft/Phi-3-vision-128k-instruct]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="phi3_vision_4_2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064, act="swiglu",
    frontend="vision_stub", img_tokens=576,
)

SMOKE = ModelConfig(
    name="phi3_vision_4_2b_smoke", family="vlm",
    num_layers=2, d_model=48, num_heads=4, num_kv_heads=4, head_dim=12,
    d_ff=96, vocab_size=256, act="swiglu",
    frontend="vision_stub", img_tokens=16, attn_chunk=32, dtype="float32",
)
