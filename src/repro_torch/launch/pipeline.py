"""Pipeline parallelism, the GPipe schedule (port of
``repro.launch.pipeline``, :26-91).

Layers are split into S stages (stage s owns a contiguous slab of the
stacked params, on its device of the mesh's ``axis``). The batch is
split into M microbatches. For T = M + S − 1 ticks every stage applies
its slab to the activation it holds, then ``ppermute`` shifts the
activations in flight stage s → s+1 (a ``.to`` of each to the next
stage's device). Stage s processes microbatch m at tick t = m + s; the
last stage collects the outputs. Bubble fraction = (S−1)/T, the
standard GPipe cost. Autograd runs the reverse schedule.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.utils.pytree import map_with_names, tree_leaves


def _slab(stage_params: Any, i: int, device) -> Any:
    return map_with_names(lambda _, a: a[i].to(device), stage_params)


def pipeline_apply(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_micro: torch.Tensor, mesh,
                   axis: str = "pipe") -> torch.Tensor:
    """Run microbatched inputs through a layer pipeline on a 1-D mesh.

    layer_fn(params_slab, x) -> x   — one stage's computation
    stage_params: tree of tensors with leading dim S (one slab a stage)
    x_micro: (M, mb, ...) microbatches
    Returns (M, mb, ...), the last stage's outputs, on the mesh's lead
    device."""
    if tuple(mesh.shape) != (axis,):
        raise ValueError(f"pipeline_apply needs a 1-D mesh over {axis!r}, "
                         f"got {mesh.shape}")
    s = mesh.shape[axis]
    m = x_micro.shape[0]
    if tree_leaves(stage_params)[0].shape[0] != s:
        raise ValueError("stage_params' leading dim must equal the stages")
    coords = mesh.coords()
    slabs = {c: _slab(stage_params, c[0], mesh.device(c)) for c in coords}
    buf = {c: torch.zeros_like(x_micro[0], device=mesh.device(c)) for c in coords}
    outs = []
    ring = [(i, (i + 1) % s) for i in range(s)]
    for t in range(m + s - 1):
        if t < m:                           # stage 0 ingests microbatch t
            buf[coords[0]] = x_micro[t].to(mesh.device(coords[0]))
        buf = {c: layer_fn(slabs[c], buf[c]) for c in coords}
        if t - (s - 1) >= 0:                # the last stage emits
            outs.append(buf[coords[-1]].to(mesh.lead))
        buf = mesh.ppermute(buf, axis, ring)
    return torch.stack(outs)


def sequential_apply(layer_fn, stage_params, x_micro) -> torch.Tensor:
    """Reference: the same computation without the pipeline."""
    s = tree_leaves(stage_params)[0].shape[0]
    outs = []
    for xm in x_micro:
        for i in range(s):
            xm = layer_fn(map_with_names(lambda _, a: a[i], stage_params), xm)
        outs.append(xm)
    return torch.stack(outs)
