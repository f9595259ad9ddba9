"""Shared utilities of the paper's experiments (twin of the reference's
``benchmarks/common.py``): testbed training, steady-state timing, CSV and
JSON emission, and the in-process record registry.

Timing on the card synchronizes before every clock read (the stand-in
for waiting on the result); the testbed trains by plain SGD on the
port's CNN, on ``device`` (default: the GPU).
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.report import to_device_batch
from repro_torch.data.synthetic import ClassifyConfig, batched, classify_dataset
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn
from repro_torch.utils.pytree import map_with_names, named_leaves

# every emit()/emit_json() lands here so a module can snapshot its own
# metrics without re-plumbing returns
_RECORDS: List[Tuple[str, float, str]] = []


def emit(name: str, us_per_call: float, derived: str) -> str:
    _RECORDS.append((name, float(us_per_call), derived))
    line = f"{name},{us_per_call:.2f},{derived}"
    print(line, flush=True)
    return line


def emit_json(name: str, payload: Dict) -> str:
    """One machine-readable result line: ``<name> {json}``."""
    line = f"{name} {json.dumps(payload, sort_keys=True, default=str)}"
    print(line, flush=True)
    return line


def records(prefix: str = "") -> List[Tuple[str, float, str]]:
    """Snapshot of the emitted CSV records (optionally name-filtered)."""
    return [r for r in _RECORDS if r[0].startswith(prefix)]


def steady_median(samples: Sequence[float], discard: int = 1) -> float:
    """Median after dropping the first ``discard`` samples (the first
    iterations carry cache, allocator and kernel-library warm-up)."""
    xs = list(samples)
    if len(xs) > discard + 1:
        xs = xs[discard:]
    return float(np.median(xs))


def sync() -> None:
    """Wait for the card's queued work, if the process ever used it: no
    GPU work can be pending in a process that never initialized CUDA."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit_stats(fn: Callable, iters: int = 10, warmup: int = 2,
                 repeats: int = 1, discard: int = 0) -> Dict[str, float]:
    """Steady-state timing of ``fn`` with dispersion: ``warmup`` calls,
    then ``repeats`` rounds of ``iters`` synchronized samples, the first
    ``discard`` of every round dropped; {median_us, min_us, mad_us, n}."""
    for _ in range(warmup):
        fn()
        sync()
    pooled: List[float] = []
    for _ in range(max(repeats, 1)):
        ts = []
        for _ in range(iters):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append(time.perf_counter() - t0)
        pooled.extend(ts[discard:] if len(ts) > discard else ts)
    med = float(np.median(pooled))
    return {"median_us": med * 1e6,
            "min_us": float(np.min(pooled)) * 1e6,
            "mad_us": float(np.median(np.abs(np.array(pooled) - med))) * 1e6,
            "n": float(len(pooled))}


def timeit(fn: Callable, iters: int = 10, warmup: int = 2,
           repeats: int = 1, discard: int = 0) -> float:
    """Steady-state median wall time per call in microseconds."""
    return timeit_stats(fn, iters=iters, warmup=warmup, repeats=repeats,
                        discard=discard)["median_us"]


@contextlib.contextmanager
def reproducible():
    """Inside the block (the settings restored after): cuDNN's
    deterministic convolution algorithms, and fp32 convolutions and
    matmuls without TF32. Otherwise a convolution's backward may pick an
    algorithm that adds with atomics, so two runs of one seed (two
    Hutchinson estimates, two trainings) differ in the last bits, and
    TF32 rounds fp32 operands to 10 mantissa bits."""
    flags = (torch.backends.cudnn, "deterministic", True), \
        (torch.backends.cudnn, "benchmark", False), \
        (torch.backends.cudnn, "allow_tf32", False), \
        (torch.backends.cuda.matmul, "allow_tf32", False)
    old = [getattr(mod, name) for mod, name, _ in flags]
    for mod, name, value in flags:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for (mod, name, _), value in zip(flags, old):
            setattr(mod, name, value)


def clone_params(params: Any, device: torch.device) -> Any:
    """A copy of a parameter tree on ``device`` that training may update
    in place."""
    return map_with_names(lambda _, a: a.detach().to(device).clone(), params)


def sgd(params: Any, loss_fn: Callable[[Any, Any], torch.Tensor],
        batches: Iterable[Tuple[np.ndarray, ...]], lr: float, steps: int,
        device: torch.device) -> Any:
    """``steps`` plain SGD steps, ``p ← p − lr·∇p``, on the first numpy
    batches of ``batches``; updates ``params`` in place and returns it."""
    leaves = [p.requires_grad_(True) for _, p in named_leaves(params)]
    try:
        for i, b in enumerate(batches):
            if i >= steps:
                break
            grads = torch.autograd.grad(loss_fn(params, to_device_batch(b, device)),
                                        leaves)
            with torch.no_grad():
                for p, g in zip(leaves, grads):
                    p.sub_(lr * g)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return params


def train_cnn_testbed(seed: int = 0, batchnorm: bool = True, steps: int = 300,
                      input_hw: int = 8, num_classes: int = 4,
                      filters: int = 8, n_train: int = 2048,
                      lr: float = 3e-3, device: DeviceLike = None,
                      params: Optional[Any] = None):
    """Train the paper's small CNN (App. D) on the synthetic classify set.
    ``params`` (a tree shaped as ``init_cnn``'s) replaces the seeded init;
    it is copied, not updated. Returns (params, (xtr, ytr), (xte, yte),
    test accuracy)."""
    dev = resolve_device(device)
    dcfg = ClassifyConfig(input_hw=input_hw, num_classes=num_classes, seed=seed)
    xtr, ytr = classify_dataset(dcfg, n_train)
    xte, yte = classify_dataset(dcfg, 512, split_seed=101)
    if params is None:
        params = init_cnn(seed, num_classes=num_classes, input_hw=input_hw,
                          filters=filters, batchnorm=batchnorm, device=dev)
    else:
        params = clone_params(params, dev)
    sgd(params, cnn_loss, batched(xtr, ytr, 128, seed=seed), lr, steps, dev)
    acc = cnn_accuracy(params, *to_device_batch((xte, yte), dev))
    return params, (xtr, ytr), (xte, yte), acc
