"""End-to-end training loop on the PyTorch/CUDA port: a ~20M-param
llama-family model trained for a few hundred steps on the synthetic LM
stream with checkpointing, auto-resume, watchdog, and optional QAT — the
full production loop at small scale (pass --dim/--layers to scale up).
Runs on the GPU unless given ``--device cpu``.

    PYTHONPATH=src python examples/train_e2e_torch.py [--steps 200] [--qat 4]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import repro_torch.configs.llama3_8b as llama_cfg_mod  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--dim", type=int, default=256)
ap.add_argument("--layers", type=int, default=4)
ap.add_argument("--qat", type=int, default=None)
ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                               "repro_torch_e2e_ckpt"))
ap.add_argument("--device", default=None, help="default: the GPU")
args = ap.parse_args()

# a ~20M-param llama3-family config
cfg = ModelConfig(
    name="llama3_e2e_20m", family="dense",
    num_layers=args.layers, d_model=args.dim, num_heads=8, num_kv_heads=4,
    head_dim=args.dim // 8, d_ff=args.dim * 3, vocab_size=8192,
    act="swiglu", rope_theta=500000.0, attn_chunk=128, dtype="float32",
    remat=False)

# expose it through the training entry point's config lookup
llama_cfg_mod.SMOKE = cfg

result = train(
    arch="llama3_8b", smoke=True, steps=args.steps, batch=8, seq=256,
    ckpt_dir=args.ckpt, resume=True, ckpt_every=50,
    qat_weight_bits=args.qat, qat_act_bits=8 if args.qat else None,
    watchdog_s=120.0, lr=1e-3, device=args.device)

print(f"\nfinal loss: {result['final_loss']:.4f} "
      f"(from {result['losses'][0]:.4f})")
print(f"checkpoints in {args.ckpt}; rerun with the same command to resume.")
