"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000. Pruned Nemotron (squared-ReLU MLP). [arXiv:2407.14679]"""
from repro_torch.configs import ModelConfig

CONFIG = ModelConfig(
    name="minitron_4b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
    d_ff=9216, vocab_size=256000, act="relu2",
)

SMOKE = ModelConfig(
    name="minitron_4b_smoke", family="dense",
    num_layers=2, d_model=48, num_heads=3, num_kv_heads=1, head_dim=16,
    d_ff=144, vocab_size=512, act="relu2", attn_chunk=32, dtype="float32",
)
