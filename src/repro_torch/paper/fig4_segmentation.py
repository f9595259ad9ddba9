"""Paper Fig. 4 / Sec. 4.3: FIT generalizes to semantic segmentation —
U-Net on a synthetic Cityscapes stand-in, FIT vs mIoU over random MPQ
configs (paper reports rho = 0.86 over 50 configs); twin of the
reference's ``benchmarks/fig4_segmentation.py``."""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import build_report, metric_accuracy_correlation, sample_configs
from repro_torch.core.report import to_device_batch
from repro_torch.data.synthetic import SegmentConfig, batched, segment_dataset
from repro_torch.models.context import QATContext
from repro_torch.models.unet import (
    init_unet, unet_act_fn, unet_forward, unet_loss, unet_miou,
    unet_tap_loss, unet_tap_shapes)
from repro_torch.paper.common import clone_params, emit, sgd
from repro_torch.quant.policy import QuantPolicy

N_CONFIGS = int(os.environ.get("REPRO_F4_CONFIGS", 10))
QAT_STEPS = int(os.environ.get("REPRO_F4_QAT_STEPS", 50))
STEPS = 300             # full-precision SGD steps


def train_unet(device: torch.device, params: Optional[Any] = None,
               steps: int = STEPS):
    """The U-Net (base 8) trained by SGD (lr 5e-3, batches of 64) on 512
    16×16 segmentation images; ``params`` replaces the seeded init (it is
    copied). Returns (params, (xtr, ytr), (xte, yte), fp mIoU)."""
    dcfg = SegmentConfig(input_hw=16, seed=0)
    xtr, ytr = segment_dataset(dcfg, 512)
    xte, yte = segment_dataset(dcfg, 128, split_seed=3)
    params = (init_unet(0, base=8, device=device) if params is None
              else clone_params(params, device))
    sgd(params, unet_loss, batched(xtr, ytr, 64, seed=0), 5e-3, steps, device)
    fp_miou = unet_miou(params, *to_device_batch((xte, yte), device))
    return params, (xtr, ytr), (xte, yte), fp_miou


def measure(params: Any, train: tuple, test: tuple,
            device: torch.device) -> Dict:
    """One report on 128 training images; for ``N_CONFIGS`` random configs
    (seed 7) ``QAT_STEPS`` SGD steps (lr 2e-3) through the config's fake
    quantization from a copy of ``params``, the test mIoU (a class absent
    from prediction and labels counts 1) and FIT; their Spearman."""
    (xtr, ytr), (xte, yte) = train, test
    batch = to_device_batch((xtr[:128], ytr[:128]), device)
    report = build_report(unet_loss, unet_tap_loss,
                          lambda b: unet_tap_shapes(params, b), unet_act_fn,
                          params, [batch], tolerance=None, max_batches=1,
                          device=device)
    policy = QuantPolicy(allowed_bits=(8, 6, 4, 3), pinned_substrings=())
    configs = sample_configs(report, policy, N_CONFIGS, seed=7)
    x_te, y_te = to_device_batch((xte, yte), device)
    y_te = y_te.long()
    mious, fits = [], []
    for c in configs:
        lw = {k: float(2 ** b - 1) for k, b in c.weight_bits.items()}
        la = {k: float(2 ** b - 1) for k, b in c.act_bits.items()}
        qp = sgd(clone_params(params, device),
                 lambda p, b: unet_loss(p, b, ctx=QATContext(lw, la)),
                 batched(xtr, ytr, 64, seed=5), 2e-3, QAT_STEPS, device)
        with torch.no_grad():
            pred = torch.argmax(unet_forward(qp, x_te, ctx=QATContext(lw, la)), -1)
        ious = []
        for cc in range(4):
            inter = torch.sum((pred == cc) & (y_te == cc)).to(torch.float32)
            union = torch.sum((pred == cc) | (y_te == cc)).to(torch.float32)
            ious.append(torch.where(union > 0, inter / union, torch.ones_like(union)))
        mious.append(float(np.mean([float(v) for v in ious])))
        fits.append(report.fit(c))
    return {"configs": len(configs),
            "fit_miou_spearman": metric_accuracy_correlation(fits, mious)["spearman"],
            "fits": fits, "mious": mious, "weight_traces": report.weight_traces,
            "act_traces": report.act_traces}


def run(device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    params, train, test, fp_miou = train_unet(dev)
    emit("fig4.fp_miou", 0.0, f"{fp_miou:.3f}")
    out = measure(params, train, test, dev)
    emit("fig4.configs", 0.0, str(out["configs"]))
    emit("fig4.fit_miou_spearman", 0.0, f"{out['fit_miou_spearman']:.3f}")
    return {"fp_miou": fp_miou, **out}


if __name__ == "__main__":
    run()
