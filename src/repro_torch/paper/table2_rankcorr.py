"""Paper Table 2: rank correlation between sensitivity metrics and final
quantized accuracy across randomly sampled MPQ configurations (twin of
the reference's ``benchmarks/table2_rankcorr.py``).

Four studies (A/B = "cifar-like" wider testbed with/without BN, C/D =
"mnist-like" narrower testbed with/without BN). For each study: train the
FP model, sample N random bit configs, QAT-finetune each briefly, measure
test accuracy, and report |Spearman| for every metric (FIT, FIT_W, FIT_A,
QR, QR_W, QR_A, Noise, BN).

Scaled down from the paper's 100 configs × 30 epochs to N configs × a
few dozen QAT steps; the claim validated is the ORDERING of the metric
correlations, FIT high and stable. ``run`` returns the table; the
harness (``repro_torch.paper.run --out``) writes it.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import (build_report, metric_accuracy_correlation,
                              metric_values_batch, sample_packed)
from repro_torch.core.heuristics import ALL_METRICS
from repro_torch.core.report import to_device_batch
from repro_torch.data.synthetic import batched
from repro_torch.models.cnn import (
    cnn_act_fn, cnn_forward, cnn_loss, cnn_tap_loss, cnn_tap_shapes)
from repro_torch.models.context import QATContext
from repro_torch.paper.common import clone_params, emit, sgd, train_cnn_testbed
from repro_torch.quant.policy import BitConfig, QuantPolicy

N_CONFIGS = int(os.environ.get("REPRO_T2_CONFIGS", 12))
QAT_STEPS = int(os.environ.get("REPRO_T2_QAT_STEPS", 60))

STUDIES = [
    ("A_cifarlike_bn", 10, True, 16),
    ("B_cifarlike_nobn", 11, False, 16),
    ("C_mnistlike_bn", 12, True, 8),
    ("D_mnistlike_nobn", 13, False, 8),
]


def _levels(cfg: BitConfig) -> Tuple[Dict[str, float], Dict[str, float]]:
    return ({k: float(2 ** b - 1) for k, b in cfg.weight_bits.items()},
            {k: float(2 ** b - 1) for k, b in cfg.act_bits.items()})


def _qat_accuracy(params: Any, cfg: BitConfig, xtr, ytr, xte, yte,
                  device: torch.device) -> float:
    """``QAT_STEPS`` SGD steps (lr 1e-3, batches of seed 11) through the
    config's fake quantization from a copy of ``params``; its quantized
    test accuracy."""
    lw, la = _levels(cfg)
    qp = sgd(clone_params(params, device),
             lambda p, b: cnn_loss(p, b, ctx=QATContext(lw, la)),
             batched(xtr, ytr, 128, seed=11), 1e-3, QAT_STEPS, device)
    x, y = to_device_batch((xte, yte), device)
    with torch.no_grad():
        logits = cnn_forward(qp, x, ctx=QATContext(lw, la))
    return float(torch.mean((torch.argmax(logits, -1) == y.long()).to(torch.float32)))


def _study_detail(name: str, seed: int, batchnorm: bool, filters: int,
                  device: DeviceLike = None, params: Optional[Any] = None
                  ) -> Tuple[Dict[str, float], Dict[str, List]]:
    """One study: (its row of the table, the per-config numbers behind
    it: accuracies and every metric's values). ``params`` replaces the
    testbed's seeded init."""
    dev = resolve_device(device)
    params, (xtr, ytr), (xte, yte), fp_acc = train_cnn_testbed(
        seed=seed, batchnorm=batchnorm, filters=filters, device=dev,
        params=params)
    batch = to_device_batch((xtr[:256], ytr[:256]), dev)
    report = build_report(cnn_loss, cnn_tap_loss,
                          lambda b: cnn_tap_shapes(params, b), cnn_act_fn,
                          params, [batch], tolerance=None, max_batches=1,
                          device=dev)
    policy = QuantPolicy(allowed_bits=(8, 6, 4, 3), pinned_substrings=("bn",))
    # sample + score in packed index space: every metric is one
    # gather+row-sum over the batch, not a dict loop per config
    packed, W, A = sample_packed(report, policy, N_CONFIGS, seed=seed)
    configs = [packed.decode(W[i], A[i]) for i in range(N_CONFIGS)]

    accs = [_qat_accuracy(params, c, xtr, ytr, xte, yte, dev) for c in configs]

    gammas = None
    if batchnorm:
        gammas = {f"conv{i}/w": float(torch.mean(torch.abs(params[f"bn{i}"]["gamma"])))
                  for i in (1, 2, 3)}

    out = {"fp_acc": fp_acc, "acc_spread": float(np.ptp(accs))}
    detail: Dict[str, List] = {"accs": accs, "configs": configs}
    for mname in ALL_METRICS:
        vals = metric_values_batch(report, mname, packed.levels, W, A)
        detail[mname] = list(vals)
        out[mname] = metric_accuracy_correlation(list(vals), accs)["spearman"]
    if gammas:
        vals = metric_values_batch(report, "BN", packed.levels, W, A,
                                   gammas=gammas)
        detail["BN"] = list(vals)
        out["BN"] = metric_accuracy_correlation(list(vals), accs)["spearman"]
    return out, detail


def _study(name: str, seed: int, batchnorm: bool, filters: int,
           device: DeviceLike = None, params: Optional[Any] = None
           ) -> Dict[str, float]:
    """One study's row of the table: fp accuracy, the spread of the
    quantized accuracies and every metric's Spearman against them."""
    return _study_detail(name, seed, batchnorm, filters, device, params)[0]


def summarize(results: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """The headline claims: FIT's mean Spearman over the studies and its
    gain over FIT_W's."""
    fit_mean = float(np.mean([r["FIT"] for r in results.values()]))
    fitw_mean = float(np.mean([r["FIT_W"] for r in results.values()]))
    return {"FIT_mean": fit_mean, "FIT_vs_FITW_gain": fit_mean - fitw_mean}


def run(device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    results = {}
    for name, seed, bn, filters in STUDIES:
        res = _study(name, seed, bn, filters, dev)
        results[name] = res
        for metric, val in res.items():
            if metric in ("fp_acc", "acc_spread"):
                continue
            emit(f"table2.{name}.{metric}", 0.0, f"{val:.3f}")
        emit(f"table2.{name}.fp_acc", 0.0, f"{res['fp_acc']:.3f}")
    head = summarize(results)
    emit("table2.FIT_mean", 0.0, f"{head['FIT_mean']:.3f}")
    emit("table2.FIT_vs_FITW_gain", 0.0, f"{head['FIT_vs_FITW_gain']:+.3f}")
    return {"studies": results, **head}


if __name__ == "__main__":
    run()
