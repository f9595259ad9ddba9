"""Gradient compression with error feedback (port of
``repro.optim.compression``, :1-78).

Int8 uniform quantization of gradients before the data-parallel
all-reduce, with per-leaf error-feedback buffers (Seide et al. / 1-bit
Adam lineage): the quantization residual is carried into the next step,
so the accumulated update is unbiased.

  * ``compress_leaf``/``decompress_leaf`` + ``ef_transform`` — pure
    functions over a tree of tensors (a bare tensor is a tree of one).
  * ``compressed_psum`` — over a ``launch.mesh.Mesh``: int8 values on a
    shared symmetric scale (the ``pmax`` of the shards' maxima), summed
    exactly in int32 and divided by the shard count (the reference's
    :62-78). The int8 payloads are all-gathered and each shard adds them
    in int32: integer adds are exact, so the result is the reference's
    int32 psum bit for bit, and a shard sends 1 byte an element.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.utils.pytree import map_with_names, named_leaves


class EFState(NamedTuple):
    error: Any                       # tree matching grads (fp32 residuals)


def init_ef(params: Any) -> EFState:
    return EFState(error=map_with_names(
        lambda _, p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def compress_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp -> (int8 values, fp32 scale). Symmetric per-tensor."""
    g32 = g.to(torch.float32)
    scale = torch.clamp_min(torch.amax(torch.abs(g32)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_transform(grads: Any, ef: EFState) -> Tuple[Any, EFState]:
    """Error-feedback compression: (decompressed grads, new state). The
    returned grads are what the optimizer consumes; the residual
    (grad + error − decompressed) feeds back next step."""
    errors = dict(named_leaves(ef.error))
    new_err: Dict[str, torch.Tensor] = {}

    def one(name, g):
        target = g.to(torch.float32) + errors[name]
        q, s = compress_leaf(target)
        d = decompress_leaf(q, s)
        new_err[name] = target - d
        return d.to(g.dtype)

    newg = map_with_names(one, grads)
    return newg, EFState(error=map_with_names(lambda name, _: new_err[name],
                                              ef.error))


def compressed_psum(parts: Dict[Any, torch.Tensor], mesh, axes
                    ) -> Dict[Any, torch.Tensor]:
    """Int8-compressed mean over ``axes`` of a ``Mesh``: every shard of a
    group gets (Σ_i q_i) · scale / n in its part's dtype, with q_i =
    clip(round(g_i / scale), ±127) and scale = max(pmax |g|, 1e-12) / 127."""
    g32 = {c: p.to(torch.float32) for c, p in parts.items()}
    gmax = mesh.pmax({c: torch.amax(torch.abs(g)) for c, g in g32.items()}, axes)
    scale = {c: torch.clamp_min(gmax[c], 1e-12) / 127.0 for c in parts}
    q = {c: torch.clamp(torch.round(g32[c] / scale[c]), -127, 127).to(torch.int8)
         for c in parts}
    n = mesh.axis_size(axes)
    gathered = mesh.all_gather({c: v[None] for c, v in q.items()}, axes, dim=0)
    out = {}
    for c, p in parts.items():
        total = torch.sum(gathered[c].to(torch.int32), dim=0, dtype=torch.int32)
        out[c] = (total.to(torch.float32) * scale[c] / float(n)).to(p.dtype)
    return out
