"""Paper Fig. 1: EF traces preserve the relative block sensitivity of the
Hessian traces — reported as the per-block rank correlation between the
two trace vectors on the trained testbed CNN (twin of the reference's
``benchmarks/fig1_trace_similarity.py``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch._device import DeviceLike, generator, resolve_device
from repro_torch.core import (
    ef_trace_weights, hutchinson_block_traces, pearson, spearman)
from repro_torch.core.report import to_device_batch
from repro_torch.models.cnn import cnn_loss
from repro_torch.paper.common import emit, train_cnn_testbed

PROBES = 200            # Hutchinson probes
SAMPLES = 256           # EF samples


def measure(params: Any, batch: Any, device: torch.device,
            probes: int = PROBES) -> Dict:
    """EF traces and Hutchinson's (``probes`` Rademacher probes from the
    generator of seed 0; the per-probe samples too) on one batch; their
    Spearman and Pearson over the blocks in sorted order."""
    ef = ef_trace_weights(cnn_loss, params, batch)
    hu, samples = hutchinson_block_traces(cnn_loss, params, batch,
                                          generator(device, 0), iters=probes)
    blocks = sorted(ef)
    ef_v = [ef[b] for b in blocks]
    hu_v = [hu[b] for b in blocks]
    return {"blocks": len(blocks), "ef_hessian_spearman": spearman(ef_v, hu_v),
            "ef_hessian_pearson": pearson(ef_v, hu_v), "ef": ef, "hessian": hu,
            "hessian_samples": {k: v.tolist() for k, v in samples.items()}}


def run(device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    params, (xtr, ytr), _, _ = train_cnn_testbed(seed=1, batchnorm=False,
                                                 device=dev)
    out = measure(params, to_device_batch((xtr[:SAMPLES], ytr[:SAMPLES]), dev),
                  dev)
    emit("fig1.blocks", 0.0, str(out["blocks"]))
    emit("fig1.ef_hessian_spearman", 0.0, f"{out['ef_hessian_spearman']:.3f}")
    emit("fig1.ef_hessian_pearson", 0.0, f"{out['ef_hessian_pearson']:.3f}")
    return out


if __name__ == "__main__":
    run()
