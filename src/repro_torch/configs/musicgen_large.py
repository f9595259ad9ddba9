"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048. Decoder-only over EnCodec tokens; the EnCodec frontend is a
STUB (input_specs provides precomputed frame embeddings). GELU MLP.
[arXiv:2306.05284]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="musicgen_large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048, act="gelu",
    frontend="audio_stub", num_codebooks=4,
)

SMOKE = ModelConfig(
    name="musicgen_large_smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=128, act="gelu",
    frontend="audio_stub", num_codebooks=2, attn_chunk=32, dtype="float32",
)
