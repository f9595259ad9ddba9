"""One-call entry point: build a ``SensitivityReport`` from a model and
data (port of ``repro.core.report``)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.fisher import (
    ef_trace_activations, ef_trace_weights_streaming)
from repro_torch.core.fit import SensitivityReport
from repro_torch.utils.pytree import named_leaves, tree_map


def to_device_batch(batch: Any, device) -> Any:
    """A batch pytree (dicts, tuples, lists of numpy or torch arrays) ->
    the same structure of torch tensors on ``device``, leaf by leaf."""
    return tree_map(lambda v: torch.as_tensor(
        v if isinstance(v, torch.Tensor) else np.asarray(v)).to(device), batch)


def weight_ranges(params: Any) -> Dict[str, tuple]:
    """min-max (containing 0) per block — min-max calibration."""
    out = {}
    for name, leaf in named_leaves(params):
        lo = float(torch.clamp_max(torch.min(leaf), 0.0))
        hi = float(torch.clamp_min(torch.max(leaf), 0.0))
        out[name] = (lo, hi)
    return out


def act_ranges(act_fn: Callable[[Any, Any], Mapping[str, torch.Tensor]],
               params: Any, batches: Iterable[Any]) -> Dict[str, tuple]:
    """Calibrate activation min-max over batches."""
    lo: Dict[str, float] = {}
    hi: Dict[str, float] = {}
    for batch in batches:
        with torch.no_grad():
            acts = act_fn(params, batch)
        for name, a in acts.items():
            alo = float(torch.clamp_max(torch.min(a), 0.0))
            ahi = float(torch.clamp_min(torch.max(a), 0.0))
            lo[name] = min(lo.get(name, 0.0), alo)
            hi[name] = max(hi.get(name, 0.0), ahi)
    return {k: (lo[k], hi[k]) for k in lo}


def build_report(loss_fn: Callable, tap_loss_fn: Optional[Callable],
                 tap_shapes_fn: Optional[Callable], act_fn: Optional[Callable],
                 params: Any, batches: Iterable[Any],
                 microbatch: Optional[int] = None,
                 tolerance: Optional[float] = 0.01, max_batches: int = 64,
                 mesh=None, mesh_axis: Optional[str] = None,
                 device: DeviceLike = None) -> SensitivityReport:
    """EF traces (weights + activations) and calibration ranges over up
    to ``max_batches`` batches (any pytree), moved to ``device`` (default:
    the GPU). ``mesh`` (a ``TPMesh`` or a 1-D ``Mesh``) runs the weight traces
    data-parallel: batch shards on its devices, per-block squared norms
    summed on the lead device (``fisher.ef_trace_weights``, which also
    says why ``microbatch`` and ``mesh_axis`` change nothing)."""
    dev = resolve_device(device)
    batches = [to_device_batch(b, dev) for b in list(batches)[:max_batches]]
    if not batches:
        raise ValueError("need at least one calibration batch")
    wtraces, used = ef_trace_weights_streaming(
        loss_fn, params, batches, microbatch=microbatch, tolerance=tolerance,
        mesh=mesh, mesh_axis=mesh_axis)
    atraces: Dict[str, float] = {}
    aranges: Dict[str, tuple] = {}
    if tap_loss_fn is not None and tap_shapes_fn is not None:
        sums: Dict[str, float] = {}
        for batch in batches[:max(used, 1)]:
            with torch.no_grad():
                shapes = tap_shapes_fn(batch)
            t = ef_trace_activations(tap_loss_fn, params, shapes, batch)
            for k, v in t.items():
                sums[k] = sums.get(k, 0.0) + v
        atraces = {k: v / max(used, 1) for k, v in sums.items()}
        if act_fn is not None:
            aranges = act_ranges(act_fn, params, batches[:max(used, 1)])
    sizes = {name: int(leaf.numel()) for name, leaf in named_leaves(params)}
    return SensitivityReport(weight_traces=wtraces, act_traces=atraces,
                             weight_ranges=weight_ranges(params),
                             act_ranges=aranges, param_sizes=sizes)
