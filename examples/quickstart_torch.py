"""Quickstart on the PyTorch/CUDA port: FIT in ~60 lines.

Train a small model, compute the FIT sensitivity report from the trained
FP model (one pass of per-sample gradients), score mixed-precision
configurations WITHOUT retraining, and pick one with the greedy
allocator. Runs on the GPU unless given ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch._device import resolve_device
from repro_torch.core import build_report, greedy_allocate, sample_configs
from repro_torch.core.mpq import pareto_front
from repro_torch.data.synthetic import ClassifyConfig, batched, classify_dataset
from repro_torch.models.cnn import (
    cnn_accuracy, cnn_act_fn, cnn_loss, cnn_tap_loss, cnn_tap_shapes, init_cnn)
from repro_torch.quant.policy import QuantPolicy
from repro_torch.utils.pytree import named_leaves

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="default: the GPU")
dev = resolve_device(ap.parse_args().device)

# ---- 1. train a full-precision model -------------------------------------
dcfg = ClassifyConfig(input_hw=8, num_classes=4, seed=0)
xtr, ytr = classify_dataset(dcfg, 2048)
xte, yte = classify_dataset(dcfg, 512, split_seed=1)
params = init_cnn(0, num_classes=4, input_hw=8, filters=8, batchnorm=False,
                  device=dev)
leaves = [p.requires_grad_(True) for _, p in named_leaves(params)]
for i, (x, y) in enumerate(batched(xtr, ytr, 128, seed=0)):
    if i >= 300:
        break
    grads = torch.autograd.grad(
        cnn_loss(params, (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))),
        leaves)
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.sub_(3e-3 * g)
for p in leaves:
    p.requires_grad_(False)
acc = cnn_accuracy(params, torch.from_numpy(xte).to(dev), torch.from_numpy(yte).to(dev))
print(f"FP accuracy: {acc:.3f}")

# ---- 2. one-shot FIT sensitivity report -----------------------------------
report = build_report(
    loss_fn=cnn_loss,
    tap_loss_fn=cnn_tap_loss,                    # activation manifold (Sec 3.2.1)
    tap_shapes_fn=lambda b: cnn_tap_shapes(params, b),
    act_fn=cnn_act_fn,                           # activation range calibration
    params=params, batches=[(xtr[:256], ytr[:256])], tolerance=None,
    max_batches=1, device=dev)

print("\nper-block EF traces (weights):")
for k, v in sorted(report.weight_traces.items()):
    print(f"  {k:12s} {v:10.4f}   n={report.param_sizes[k]}")
print("per-site EF traces (activations):")
for k, v in sorted(report.act_traces.items()):
    print(f"  {k:12s} {v:10.4f}")

# ---- 3. score configs without retraining + allocate ------------------------
policy = QuantPolicy(allowed_bits=(8, 6, 4, 3), pinned_substrings=())
total_params = sum(report.param_sizes.values())
for avg_bits in (6, 5, 4):
    cfg = greedy_allocate(report, policy, budget_bits=avg_bits * total_params)
    print(f"\nbudget {avg_bits} bits/param -> FIT={report.fit(cfg):.5f}")
    print("  bits:", dict(sorted(cfg.weight_bits.items())))

# ---- 4. Pareto front over random configs ----------------------------------
configs = sample_configs(report, policy, 64, seed=0)
front = pareto_front(report, configs)
print(f"\nPareto front ({len(front)} points) over 64 random configs:")
for size, fit, _ in front[:6]:
    print(f"  {size / total_params:5.2f} bits/param   FIT={fit:.5f}")
