"""Mixed-precision search + QAT on an assigned LM architecture, on the
PyTorch/CUDA port. Runs on the GPU unless given ``--device cpu``.

End-to-end on a reduced llama3-family config:
  1. pretrain full precision on the synthetic LM stream,
  2. compute per-block FIT sensitivities on the trained model,
  3. allocate layer-wise bits with the greedy knapsack under a 4.5-bit
     average budget (vs uniform-4 baseline), and cross-check against a
     4096-config random search scored in one batched gather + row-sum,
  4. QAT-finetune the configurations and compare final loss.

    PYTHONPATH=src python examples/mpq_search_torch.py [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.core import build_report, greedy_allocate, sample_packed
from repro_torch.core.report import to_device_batch
from repro_torch.data.synthetic import LMStreamConfig, lm_batches
from repro_torch.launch.steps import bitconfig_to_levels
from repro_torch.models import init_params, loss_fn
from repro_torch.qtensor import storage_summary
from repro_torch.quant.policy import BitConfig, QuantPolicy
from repro_torch.serve import quantize_params
from repro_torch.utils.pytree import map_with_names, named_leaves

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="default: the GPU")
dev = resolve_device(ap.parse_args().device)

cfg = dataclasses.replace(smoke_config("llama3_8b"), num_layers=3)
params = init_params(cfg, seed=0, device=dev)
stream = lm_batches(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                   global_batch=8, seed=0))


def lm_loss(p, batch):
    return loss_fn(p, batch, cfg)


def sgd(p, loss, lr, steps, log_every=0):
    """``steps`` plain SGD steps on the stream, in place; the last loss."""
    leaves = [a.requires_grad_(True) for _, a in named_leaves(p)]
    for i in range(steps):
        value = loss(p, to_device_batch(next(stream), dev))
        grads = torch.autograd.grad(value, leaves)
        with torch.no_grad():
            for a, g in zip(leaves, grads):
                a.sub_(lr * g)
        if log_every and i % log_every == 0:
            print(f"  step {i} loss {float(value.detach()):.3f}")
    for a in leaves:
        a.requires_grad_(False)
    return float(value.detach())


print("pretraining FP...")
fp_loss = sgd(params, lm_loss, 1e-1, 150, log_every=50)

print("computing FIT report (per-sample gradient traces)...")
calib = [next(stream) for _ in range(4)]
report = build_report(lm_loss, None, None, None, params, calib,
                      microbatch=4, tolerance=None, max_batches=4, device=dev)

policy = QuantPolicy(allowed_bits=(8, 6, 4, 3))
total = sum(report.param_sizes.values())
fit_cfg = greedy_allocate(report, policy, budget_bits=4.5 * total)
uniform = BitConfig({k: 4 for k in report.weight_traces}, {})
print(f"FIT(greedy@4.5b) = {report.fit(fit_cfg):.5f}  "
      f"FIT(uniform-4) = {report.fit(uniform):.5f}")

# random-search cross-check: 4096 configs scored in a single batched
# gather+row-sum (the PackedReport engine) — Table-2 style at scale
t0 = time.perf_counter()
packed, W, _ = sample_packed(report, policy, 4096, seed=0)
fits = packed.fit_weights_batch(W)
costs = packed.cost_bits_batch(W)
feasible = costs <= 4.5 * total
best = int(np.flatnonzero(feasible)[np.argmin(fits[feasible])]) \
    if feasible.any() else None
dt = time.perf_counter() - t0
if best is not None:
    print(f"random search: scored 4096 configs in {dt*1e3:.1f} ms; "
          f"best feasible FIT_W = {fits[best]:.5f} "
          f"(greedy = {report.fit_weights(fit_cfg.weight_bits):.5f})")

top = sorted(report.weight_traces.items(), key=lambda kv: -kv[1])[:5]
print("most sensitive blocks:", [(k, round(v, 3)) for k, v in top])

# materialize the winning config as REAL packed storage and show the
# FIT-predicted budget is actually realized in HBM bytes (repro_torch.qtensor)
qparams, _ = quantize_params(params, fit_cfg, policy, device=dev)
ws = storage_summary(qparams)
print(f"greedy@4.5b materialized: FIT-predicted "
      f"{ws['predicted_bytes'] / 1024:.1f} KiB "
      f"-> packed {ws['packed_bytes'] / 1024:.1f} KiB of QTensor payload "
      f"({ws['fp16_bytes'] / ws['packed_bytes']:.1f}x under fp16)")


def qat_finetune(bit_cfg, steps=60):
    qat = bitconfig_to_levels(cfg, bit_cfg, device=dev)
    p = map_with_names(lambda _, a: a.clone(), params)
    return sgd(p, lambda pp, b: loss_fn(pp, b, cfg, qat=qat), 3e-2, steps)


print("QAT finetuning both configurations...")
l_fit = qat_finetune(fit_cfg)
l_uni = qat_finetune(uniform)
print(f"final QAT loss  fp={fp_loss:.3f}  FIT-config={l_fit:.3f}  "
      f"uniform-4={l_uni:.3f}")
print("FIT config better!" if l_fit <= l_uni else
      "uniform better on this run (small-scale noise)")
