"""Gauge snapshots: point-in-time engine state for exposition (port of
``repro.obs.gauges``).

Everything here reads HOST-side state the engine already maintains (the
block allocator, host slot mirrors, QTensor storage accounting, the
kernel loader's count, the CUDA caching allocator's counters) —
collecting a snapshot launches nothing on the device, so the exposition
cadence is free to be aggressive.

The reference's two jit-cache gauges have no counterpart: the port
compiles nothing per shape. In their place it reports the kernel
library's builds and loads (``kernels._build.loads``) and the bytes
allocated on each shard's device.
"""
from __future__ import annotations

from typing import Dict

GAUGE_HELP: Dict[str, str] = {
    "slots_active": "slots currently decoding",
    "slots_total": "engine slot capacity",
    "kv_pages_in_use": "page-pool pages with refcount > 0",
    "kv_pages_total": "page-pool capacity",
    "kv_pool_occupancy": "pages_in_use / total",
    "kv_pages_reserved": "pages held back for admitted requests' decode",
    "prefix_shared_tokens": "prefill tokens skipped via prefix sharing",
    "prefix_hit_rate": "shared / (shared + prefilled) prompt tokens",
    "kv_cow_copies": "boundary pages copied on write",
    "weight_bytes_per_shard": "packed weight HBM bytes on one shard",
    "kv_pool_bytes_per_shard": "KV page-pool HBM bytes on one shard",
    "tp_degree": "tensor-parallel shard count",
    "kernel_lib_loads": "CUDA kernel library builds or loads in this "
                        "process (0 until a kernel first runs)",
    "device_allocated_bytes": "bytes the CUDA caching allocator holds "
                              "for tensors, per shard device",
    "admission_deferrals": "admissions bounced on a full KV pool",
    "requests_finished": "requests served to completion",
    "obs_drains": "device counter drains performed",
    "obs_drain_s": "wall seconds spent draining counters",
    "router_topk_flip_rate": "mean fraction of MoE router top-k expert "
                             "picks the quantized forward flips vs fp "
                             "(drift-monitor samples)",
}


def collect_gauges(engine) -> Dict[str, object]:
    """Snapshot an ``Engine``'s host-visible gauges (flat dict)."""
    import torch

    from repro_torch.kernels import _build

    out: Dict[str, object] = {}
    ecfg = engine.ecfg
    active = getattr(engine, "_active", None)
    out["slots_total"] = ecfg.max_slots
    out["slots_active"] = int(active.sum()) if active is not None else 0
    out["tp_degree"] = getattr(engine, "_tp", 1)

    alloc = getattr(engine, "_alloc", None)
    if alloc is not None:
        out["kv_pages_in_use"] = alloc.pages_in_use
        out["kv_pages_total"] = alloc.num_pages
        out["kv_pool_occupancy"] = (alloc.pages_in_use / alloc.num_pages
                                    if alloc.num_pages else 0.0)
        out["kv_pages_reserved"] = sum(alloc._reserved.values())
        out["prefix_shared_tokens"] = alloc.shared_tokens
        out["kv_cow_copies"] = alloc.cow_copies
        metrics = getattr(engine, "metrics", None)
        prefilled = getattr(metrics, "prefill_tokens", 0) if metrics else 0
        denom = alloc.shared_tokens + prefilled
        out["prefix_hit_rate"] = (alloc.shared_tokens / denom
                                  if denom else 0.0)
        page_bytes = getattr(engine, "_page_bytes", 0.0)
        out["kv_pool_bytes_per_shard"] = (
            alloc.num_pages * page_bytes / getattr(engine, "_kv_shards", 1))

    # per-shard weight bytes: under a mesh ``engine.params`` is shard 0's
    # tree, whose planned blocks hold that shard's slices
    from repro_torch.qtensor import tree_has_qtensor
    from repro_torch.serve.quantized import weight_storage_bytes
    if tree_has_qtensor(engine.params):
        out["weight_bytes_per_shard"] = weight_storage_bytes(engine.params)

    out["kernel_lib_loads"] = _build.loads
    mesh = getattr(ecfg, "mesh", None)
    devices = list(mesh.devices) if mesh is not None else [engine.device]
    if all(d.type == "cuda" for d in devices):
        out["device_allocated_bytes"] = [torch.cuda.memory_allocated(d)
                                         for d in devices]

    metrics = getattr(engine, "metrics", None)
    if metrics is not None:
        out["admission_deferrals"] = getattr(metrics, "admission_deferrals",
                                             0)
        out["requests_finished"] = getattr(metrics, "n_finished", 0)
    counters = getattr(engine, "counters", None)
    if counters is not None:
        out["obs_drains"] = counters.n_drains
        out["obs_drain_s"] = counters.drain_s
    drift = getattr(engine, "_drift", None)
    flips = getattr(drift, "router_flips", None)
    if flips:
        out["router_topk_flip_rate"] = float(sum(flips) / len(flips))
    return out


def snapshot(engine) -> Dict[str, object]:
    """Gauges + drained counter totals + derived rates, one flat dict —
    the payload ``launch.serve`` exposes via ``--metrics-file/-port``."""
    out = collect_gauges(engine)
    counters = getattr(engine, "counters", None)
    if counters is not None:
        for k, v in counters.totals().items():
            out["ctr_" + k] = v
        for k, v in counters.rates().items():
            out[k] = v
    metrics = getattr(engine, "metrics", None)
    if metrics is not None:
        for k, v in metrics.summary().items():
            if isinstance(v, (int, float)) or v is None:
                out["m_" + k] = v
    return out
