"""Empirical Fisher (EF) trace estimation (port of ``repro.core.fisher``).

Paper (Prop. 5):  Tr(Î(θ)) = (1/N) Σ_i ||∇_θ f(z_i, θ)||².

Weight traces: per-sample gradients come from a loop of single-sample
``torch.autograd.grad`` calls over each microbatch; every block's
per-sample gradients then reach ``ops.ef_sqnorm`` as ONE (microbatch, N)
matrix, kept in the parameter dtype (the kernel widens to fp32 inside).

Activation traces: zero-valued additive taps at the activation sites;
sample i's loss depends only on its own activation row, so ONE batched
backward through the taps of the mean loss yields every per-sample
gradient: Tr(Î(â)) = (1/N) Σ_i ||∇_â f_i||² = N · Σ_i ||G_i||².
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.utils.pytree import map_with_names, named_leaves

LossFn = Callable[[Any, Any], torch.Tensor]   # (params, batch) -> mean loss


def _batch_size(batch) -> int:
    return next(iter(batch.values())).shape[0]


def _slice(batch, lo: int, hi: int):
    return {k: v[lo:hi] for k, v in batch.items()}


def ef_trace_weights(loss_fn: LossFn, params: Any, batch: Any,
                     microbatch: Optional[int] = None) -> Dict[str, float]:
    """EF trace per parameter block: (1/N) Σ_i ||∇_θl f(z_i)||².
    ``loss_fn(params, batch)`` must return the MEAN loss over the batch."""
    n = _batch_size(batch)
    mb = microbatch or n
    if n % mb:
        raise ValueError(f"batch {n} not divisible by microbatch {mb}")
    leaves = {name: leaf.detach().requires_grad_(True)
              for name, leaf in named_leaves(params)}
    p_grad = map_with_names(lambda name, _: leaves[name], params)
    names = list(leaves)
    sq: Dict[str, list] = {name: [] for name in names}
    for lo in range(0, n, mb):
        per_sample = []
        for i in range(lo, lo + mb):
            loss = loss_fn(p_grad, _slice(batch, i, i + 1))
            per_sample.append(torch.autograd.grad(loss, [leaves[k] for k in names]))
        for j, name in enumerate(names):
            g = torch.stack([gs[j] for gs in per_sample])   # (mb, *shape)
            sq[name].append(kops.ef_sqnorm(g.reshape(mb, -1)))
            del g
        del per_sample
    return {k: float(torch.mean(torch.cat(v))) for k, v in sq.items()}


def ef_trace_weights_streaming(loss_fn: LossFn, params: Any, batches,
                               microbatch: Optional[int] = None,
                               tolerance: Optional[float] = None,
                               min_batches: int = 4
                               ) -> Tuple[Dict[str, float], int]:
    """Streaming EF trace with the paper's fixed-tolerance early stop
    (relative SEM of the total trace). Returns (traces, batches_used)."""
    sums: Dict[str, float] = {}
    totals: list = []
    count = 0
    for batch in batches:
        t = ef_trace_weights(loss_fn, params, batch, microbatch)
        count += 1
        for k, v in t.items():
            sums[k] = sums.get(k, 0.0) + v
        totals.append(sum(t.values()))
        if tolerance is not None and count >= min_batches:
            arr = np.array(totals, dtype=np.float64)
            mean = arr.mean()
            sem = arr.std(ddof=1) / np.sqrt(count) if count > 1 else np.inf
            if mean > 0 and sem / mean < tolerance:
                break
    return {k: v / count for k, v in sums.items()}, count


def ef_trace_activations(tap_loss_fn, params: Any,
                         tap_shapes: Mapping[str, Tuple[tuple, torch.dtype]],
                         batch: Any) -> Dict[str, float]:
    """EF trace per activation site via the tap trick (one backward).
    ``tap_loss_fn(params, taps, batch)`` adds each tap at its site."""
    n = _batch_size(batch)
    dev = next(iter(batch.values())).device
    taps = {k: torch.zeros(shape, dtype=dtype, device=dev, requires_grad=True)
            for k, (shape, dtype) in tap_shapes.items()}
    loss = tap_loss_fn(params, taps, batch)
    grads = torch.autograd.grad(loss, list(taps.values()))
    out: Dict[str, float] = {}
    for name, gi in zip(taps, grads):
        rows = kops.ef_sqnorm(gi.reshape(gi.shape[0], -1))
        # ∇_{a_i} f_i = N * row_i  ⇒  (1/N) Σ_i N²||row_i||² = N Σ_i ||row_i||²
        out[name] = float(n * torch.sum(rows))
    return out
