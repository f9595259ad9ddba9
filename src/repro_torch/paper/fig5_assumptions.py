"""Paper Fig. 5 / Sec. 4.4: assumption audits (twin of the reference's
``benchmarks/fig5_assumptions.py``).

(a) small-perturbation: quantization noise magnitude << parameter
    magnitude for nearly all parameters at the bit-widths used;
(b) distributional shift: FIT correlates better with TRAIN accuracy than
    TEST accuracy (the paper reports 0.98 vs 0.90 on experiment D).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import build_report, metric_accuracy_correlation, sample_configs
from repro_torch.core.report import to_device_batch
from repro_torch.models.cnn import (
    cnn_act_fn, cnn_forward, cnn_loss, cnn_tap_loss, cnn_tap_shapes)
from repro_torch.models.context import QATContext
from repro_torch.paper.common import emit, train_cnn_testbed
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.quantizer import QuantSpec, fake_quant_ref
from repro_torch.utils.pytree import named_leaves

N_CONFIGS = int(os.environ.get("REPRO_F5_CONFIGS", 12))


def noise_below_magnitude(params: Any, bits: int = 3) -> float:
    """(a): the mean over the ≥ 2-D blocks of the share of parameters
    whose ``bits``-bit fake-quant noise lies below their magnitude."""
    frac_small = []
    for _, leaf in named_leaves(params):
        if leaf.ndim < 2:
            continue
        fq = fake_quant_ref(leaf, QuantSpec(bits=bits))
        below = torch.abs(fq - leaf) < torch.abs(leaf) + 1e-12
        frac_small.append(float(np.mean(below.cpu().numpy())))
    return float(np.mean(frac_small))


def _accuracy(params: Any, x: torch.Tensor, y: torch.Tensor, ctx) -> float:
    with torch.no_grad():
        logits = cnn_forward(params, x, ctx=ctx)
    return float(torch.mean((torch.argmax(logits, -1) == y.long()).to(torch.float32)))


def measure(params: Any, train: tuple, test: tuple,
            device: torch.device) -> Dict:
    """(b): one report on 256 training samples; for ``N_CONFIGS`` random
    configs (seed 21) FIT and the quantized model's accuracy on 512
    training samples and on the test set, and FIT's Spearman against
    each."""
    (xtr, ytr), (xte, yte) = train, test
    batch = to_device_batch((xtr[:256], ytr[:256]), device)
    report = build_report(cnn_loss, cnn_tap_loss,
                          lambda b: cnn_tap_shapes(params, b), cnn_act_fn,
                          params, [batch], tolerance=None, max_batches=1,
                          device=device)
    policy = QuantPolicy(allowed_bits=(8, 6, 4, 3), pinned_substrings=())
    configs = sample_configs(report, policy, N_CONFIGS, seed=21)
    tr = to_device_batch((xtr[:512], ytr[:512]), device)
    te = to_device_batch((xte, yte), device)
    tr_accs, te_accs, fits = [], [], []
    for c in configs:
        lw = {k: float(2 ** b - 1) for k, b in c.weight_bits.items()}
        la = {k: float(2 ** b - 1) for k, b in c.act_bits.items()}
        tr_accs.append(_accuracy(params, *tr, QATContext(lw, la)))
        te_accs.append(_accuracy(params, *te, QATContext(lw, la)))
        fits.append(report.fit(c))
    return {"fit_train_acc_spearman":
            metric_accuracy_correlation(fits, tr_accs)["spearman"],
            "fit_test_acc_spearman":
            metric_accuracy_correlation(fits, te_accs)["spearman"],
            "configs": len(configs), "fits": fits, "train_accs": tr_accs,
            "test_accs": te_accs, "weight_traces": report.weight_traces,
            "act_traces": report.act_traces}


def run(device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    params, train, test, _ = train_cnn_testbed(seed=4, batchnorm=False,
                                               device=dev)
    frac = noise_below_magnitude(params)
    emit("fig5.frac_noise_below_param_3bit", 0.0, f"{frac:.3f}")
    out = measure(params, train, test, dev)
    emit("fig5.fit_train_acc_spearman", 0.0, f"{out['fit_train_acc_spearman']:.3f}")
    emit("fig5.fit_test_acc_spearman", 0.0, f"{out['fit_test_acc_spearman']:.3f}")
    return {"frac_noise_below_param_3bit": frac, **out}


if __name__ == "__main__":
    run()
