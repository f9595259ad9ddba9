"""Paper Table 1: EF vs Hessian (Hutchinson) — per-iteration variance,
iteration time, and the fixed-tolerance speedup
s = (σ²_H·t_H)/(σ²_EF·t_EF) (twin of the reference's
``benchmarks/table1_estimator.py``).

The paper measures ResNets on a 2080Ti; here the testbed is the CNN of
App. D. The claims under test are the relative variance and the speedup
being >> 1. The port's EF weight traces take one backward a sample
(``core.fisher.per_sample_sqnorms``), so the time ratio is the port's
own. The first ``SKIP`` iterations of each estimator are left out of
the times: on the card the first call also builds or loads the kernel
library.
"""
from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch._device import DeviceLike, generator, resolve_device
from repro_torch.core import ef_trace_weights, hutchinson_block_traces
from repro_torch.core.report import to_device_batch
from repro_torch.models.cnn import cnn_loss
from repro_torch.paper.common import emit, train_cnn_testbed

ITERS = 24              # estimates of each estimator
BATCH = 32              # samples an estimate
SKIP = 2                # first iterations left out of the median times


def measure(params: Any, xtr: np.ndarray, ytr: np.ndarray,
            device: torch.device, iters: int = ITERS) -> Dict:
    """``iters`` EF estimates, then ``iters`` one-probe Hutchinson
    estimates (probe generator i), each on its own random batch of
    ``BATCH`` (one numpy generator of seed 0 draws them all, EF's first);
    each estimate's wall time ends in a host read of the traces."""
    rng = np.random.default_rng(0)

    def batch_at():
        sel = rng.permutation(len(xtr))[:BATCH]
        return to_device_batch((xtr[sel], ytr[sel]), device)

    ef_vals, ef_times = [], []
    for _ in range(iters):
        b = batch_at()
        t0 = time.perf_counter()
        t = ef_trace_weights(cnn_loss, params, b)     # host floats: synced
        ef_times.append(time.perf_counter() - t0)
        ef_vals.append(sum(t.values()))

    hu_vals, hu_times = [], []
    for i in range(iters):
        b = batch_at()
        t0 = time.perf_counter()
        ht, _ = hutchinson_block_traces(cnn_loss, params, b,
                                        generator(device, i), iters=1)
        hu_times.append(time.perf_counter() - t0)
        hu_vals.append(sum(ht.values()))

    ef_v = float(np.var(ef_vals) / (np.mean(ef_vals) ** 2 + 1e-12))
    hu_v = float(np.var(hu_vals) / (np.mean(hu_vals) ** 2 + 1e-12))
    ef_t = float(np.median(ef_times[SKIP:]))
    hu_t = float(np.median(hu_times[SKIP:]))
    return {"ef_variance_rel": ef_v, "hessian_variance_rel": hu_v,
            "ef_s": ef_t, "hessian_s": hu_t,
            "ef_over_hessian_time": ef_t / hu_t,
            "fixed_tolerance_speedup": (hu_v * hu_t) / max(ef_v * ef_t, 1e-15),
            "variance_ratio_H_over_EF": hu_v / max(ef_v, 1e-15),
            "ef_series": ef_vals, "hessian_series": hu_vals,
            "ef_times": ef_times, "hessian_times": hu_times}


def run(device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    params, (xtr, ytr), _, _ = train_cnn_testbed(seed=0, batchnorm=False,
                                                 device=dev)
    out = measure(params, xtr, ytr, dev)
    emit("table1.ef_variance_rel", out["ef_s"] * 1e6,
         f"{out['ef_variance_rel']:.4e}")
    emit("table1.hessian_variance_rel", out["hessian_s"] * 1e6,
         f"{out['hessian_variance_rel']:.4e}")
    emit("table1.fixed_tolerance_speedup", 0.0,
         f"{out['fixed_tolerance_speedup']:.1f}x")
    emit("table1.variance_ratio_H_over_EF", 0.0,
         f"{out['variance_ratio_H_over_EF']:.1f}")
    return out


if __name__ == "__main__":
    run()
