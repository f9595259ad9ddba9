"""Paper Fig. 2: estimator convergence — iterations until the running
mean stabilizes within a tolerance band, EF vs Hutchinson (twin of the
reference's ``benchmarks/fig2_convergence.py``)."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch._device import DeviceLike, generator, resolve_device
from repro_torch.core import ef_trace_weights, hutchinson_block_traces
from repro_torch.core.report import to_device_batch
from repro_torch.models.cnn import cnn_loss
from repro_torch.paper.common import emit, train_cnn_testbed

ITERS = 60              # estimates of each estimator
BATCH = 32


def _iters_to_tolerance(series: np.ndarray, tol: float = 0.05,
                        window: int = 5) -> int:
    """First iteration where the running mean stays within ±tol of the
    final estimate for `window` consecutive steps."""
    final = series.mean()
    running = np.cumsum(series) / np.arange(1, len(series) + 1)
    ok = np.abs(running - final) <= tol * abs(final) + 1e-12
    run = 0
    for i, o in enumerate(ok):
        run = run + 1 if o else 0
        if run >= window:
            return i + 1
    return len(series)


def measure(params: Any, xtr: np.ndarray, ytr: np.ndarray,
            device: torch.device, iters: int = ITERS) -> Dict:
    """``iters`` rounds, each on its own random batch of ``BATCH``: the EF
    trace sum and a one-probe Hutchinson trace sum (probe generator i)."""
    rng = np.random.default_rng(0)
    ef_series, hu_series = [], []
    for i in range(iters):
        sel = rng.permutation(len(xtr))[:BATCH]
        b = to_device_batch((xtr[sel], ytr[sel]), device)
        ef_series.append(sum(ef_trace_weights(cnn_loss, params, b).values()))
        ht, _ = hutchinson_block_traces(cnn_loss, params, b,
                                        generator(device, i), iters=1)
        hu_series.append(sum(ht.values()))
    ef_n = _iters_to_tolerance(np.array(ef_series))
    hu_n = _iters_to_tolerance(np.array(hu_series))
    return {"ef_iters_to_5pct": ef_n, "hessian_iters_to_5pct": hu_n,
            "convergence_ratio": hu_n / max(ef_n, 1),
            "ef_series": ef_series, "hessian_series": hu_series}


def run(device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    params, (xtr, ytr), _, _ = train_cnn_testbed(seed=2, batchnorm=False,
                                                 device=dev)
    out = measure(params, xtr, ytr, dev)
    emit("fig2.ef_iters_to_5pct", 0.0, str(out["ef_iters_to_5pct"]))
    emit("fig2.hessian_iters_to_5pct", 0.0, str(out["hessian_iters_to_5pct"]))
    emit("fig2.convergence_ratio", 0.0, f"{out['convergence_ratio']:.1f}x")
    return out


if __name__ == "__main__":
    run()
