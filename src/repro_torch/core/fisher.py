"""Empirical Fisher (EF) trace estimation (port of ``repro.core.fisher``).

Paper (Prop. 5):  Tr(Î(θ)) = (1/N) Σ_i ||∇_θ f(z_i, θ)||².

Weight traces: one backward a sample. Each parameter block's gradient
is reduced to its squared norm (``ops.ef_sqnorm`` on a (1, N) row, kept
in the parameter dtype; the kernel widens to fp32 inside) the moment
autograd accumulates it, and freed before the next block's: a per-sample
gradient tree never exists whole, so the peak is the parameters, one
sample's activations and the largest block's gradient, whatever the
batch or the microbatch. ``ef_sqnorm`` reduces each row on its own, so a
(1, N) row has the bits that row of a (B, N) call has.

Batches are any pytree (dicts, tuples, lists, NamedTuples) whose leaves
share the leading batch dim, as in the reference.

Data-parallel mode (``mesh``, a ``launch.mesh.TPMesh`` or a 1-D
``launch.mesh.Mesh``): the batch is split into ``mesh.size`` contiguous
shards, shard i runs on its device with the parameters replicated there (shared where
devices coincide), each shard sums its per-block squared norms in fp32,
and the sums are added on the lead device in shard order, then divided
by N.

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
from repro_torch.utils.pytree import (
    map_with_names, named_leaves, tree_leaves, tree_map)

LossFn = Callable[[Any, Any], torch.Tensor]   # (params, batch) -> mean loss


def _batch_size(batch) -> int:
    return tree_leaves(batch)[0].shape[0]


def _slice(batch, lo: int, hi: int, device=None):
    def cut(a):
        a = a[lo:hi]
        return a.to(device) if device is not None and isinstance(a, torch.Tensor) else a
    return tree_map(cut, batch)


def _grad_leaves(params) -> Tuple[Dict[str, torch.Tensor], Any]:
    """Fresh leaves that require grad (sharing the parameters' storage)
    and the parameter tree rebuilt over them."""
    leaves = {name: leaf.detach().requires_grad_(True)
              for name, leaf in named_leaves(params)}
    return leaves, map_with_names(lambda name, _: leaves[name], params)


def _mesh_axes(mesh) -> Tuple[str, ...]:
    """A ``TPMesh``'s one axis, or a ``launch.mesh.Mesh``'s axes."""
    names = getattr(mesh, "axis_names", None)
    return tuple(names) if names is not None else (mesh.axis_name,)


def _shard_devices(mesh) -> list:
    devs = mesh.devices
    return list(devs.flat) if hasattr(devs, "flat") else list(devs)


def _shard_sum(mesh, parts: list) -> torch.Tensor:
    """The shards' parts summed in shard order on the lead device."""
    if hasattr(mesh, "axis_names"):
        # rpr-ok: RPR002 data-parallel EF sums, fp32 in shard order
        return mesh.psum(dict(zip(mesh.coords(), parts)),
                         mesh.axis_names[0])[mesh.origin]
    # rpr-ok: RPR002 data-parallel EF sums, fp32 in shard order
    return mesh.psum(parts)


def _check_args(n: int, mesh, mesh_axis: Optional[str],
                microbatch: Optional[int]) -> int:
    """The number of batch shards, after the reference's checks:
    ``mesh_axis`` names the mesh's one axis, the shards and ``microbatch``
    divide the batch."""
    shards = 1 if mesh is None else mesh.size
    if mesh is not None:
        axes = _mesh_axes(mesh)
        if len(axes) != 1:
            raise ValueError(f"the data-parallel EF trace needs a 1-D mesh, "
                             f"got axes {axes}")
        if mesh_axis not in (None, axes[0]):
            raise ValueError(f"mesh_axis {mesh_axis!r}: the mesh's only axis "
                             f"is {axes[0]!r}")
    if n % shards:
        raise ValueError(f"batch {n} not divisible by {shards} shards")
    local = n // shards
    if local % (microbatch or local):
        raise ValueError(f"batch {local} not divisible by microbatch {microbatch}")
    return shards


def per_sample_sqnorms(loss_fn: LossFn, params: Any, batch: Any
                       ) -> Dict[str, torch.Tensor]:
    """{block: (N,) fp32 squared norms of the N per-sample gradients},
    one backward a sample, each block's gradient reduced by ``ef_sqnorm``
    as autograd accumulates it and freed at once. A block the sample's
    loss does not reach has a zero gradient."""
    n = _batch_size(batch)
    leaves, p_grad = _grad_leaves(params)
    rows: Dict[str, list] = {name: [] for name in leaves}

    def reduce(name):
        def hook(leaf):
            rows[name].append(kops.ef_sqnorm(leaf.grad.reshape(1, -1)))
            leaf.grad = None
        return hook

    handles = [leaf.register_post_accumulate_grad_hook(reduce(name))
               for name, leaf in leaves.items()]
    try:
        for i in range(n):
            loss = loss_fn(p_grad, _slice(batch, i, i + 1))
            torch.autograd.backward(loss, inputs=list(leaves.values()))
            for name, r in rows.items():
                if len(r) == i:
                    r.append(torch.zeros(1, dtype=torch.float32,
                                         device=leaves[name].device))
    finally:
        for h in handles:
            h.remove()
    return {name: torch.cat(r) for name, r in rows.items()}


def ef_trace_weights(loss_fn: LossFn, params: Any, batch: Any,
                     microbatch: Optional[int] = None, mesh=None,
                     mesh_axis: Optional[str] = None) -> Dict[str, float]:
    """EF trace per parameter block: (1/N) Σ_i ||∇_θl f(z_i)||².
    ``loss_fn(params, batch)`` must return the MEAN loss over the batch.
    ``mesh`` (a ``TPMesh`` or a 1-D ``Mesh``) runs the data-parallel mode.
    ``microbatch`` and ``mesh_axis`` are kept for the reference's
    signature and change neither the result nor the memory: the
    reduction holds one sample's gradients at a time whatever the
    microbatch, which must still divide the (per-shard) batch, and a
    data mesh has one axis, which ``mesh_axis`` (None: that axis) must
    name."""
    n = _batch_size(batch)
    shards = _check_args(n, mesh, mesh_axis, microbatch)
    if shards > 1:
        return _ef_trace_weights_sharded(loss_fn, params, batch, mesh)
    sq = per_sample_sqnorms(loss_fn, params, batch)
    return {k: float(torch.mean(v)) for k, v in sq.items()}


def _ef_trace_weights_sharded(loss_fn: LossFn, params: Any, batch: Any,
                              mesh) -> Dict[str, float]:
    """Data-parallel EF trace: contiguous batch shards, one per mesh
    device, per-block fp32 sums added on the lead device in shard order."""
    n = _batch_size(batch)
    local = n // mesh.size
    replicas: Dict[torch.device, Any] = {}
    names, parts = None, []
    for i, dev in enumerate(_shard_devices(mesh)):
        if dev not in replicas:
            replicas[dev] = map_with_names(lambda _, leaf: leaf.to(dev), params)
        shard = _slice(batch, i * local, (i + 1) * local, dev)
        sq = per_sample_sqnorms(loss_fn, replicas[dev], shard)
        names = list(sq)
        parts.append(torch.stack([torch.sum(sq[k]) for k in names]))
    # not a serving path: the mesh= report's contract is fp32 adds in
    # shard order, within 1e-5 of the report without a mesh
    sums = _shard_sum(mesh, parts).tolist()
    return {k: v / n for k, v in zip(names, sums)}


def ef_trace_weights_streaming(loss_fn: LossFn, params: Any, batches,
                               microbatch: Optional[int] = None,
                               tolerance: Optional[float] = None,
                               min_batches: int = 4, mesh=None,
                               mesh_axis: Optional[str] = None
                               ) -> Tuple[Dict[str, float], int]:
    """Streaming EF trace with the paper's fixed-tolerance early stop
    (relative SEM of the total trace). ``mesh`` shards each batch
    data-parallel (see ``ef_trace_weights``). Returns (traces,
    batches_used)."""
    sums: Dict[str, float] = {}
    totals: list = []
    count = 0
    for batch in batches:
        t = ef_trace_weights(loss_fn, params, batch, microbatch, mesh=mesh,
                             mesh_axis=mesh_axis)
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
    first = tree_leaves(batch)[0]
    n = first.shape[0]
    taps = {k: torch.zeros(shape, dtype=dtype, device=first.device,
                           requires_grad=True)
            for k, (shape, dtype) in tap_shapes.items()}
    loss = tap_loss_fn(params, taps, batch)
    grads = dict(zip(taps, torch.autograd.grad(loss, list(taps.values()))))
    out: Dict[str, float] = {}
    # sites in sorted order, as the reference's pytree of tap gradients
    # gives them: the report's site order sets which site each column of
    # a sampled config (``core.mpq.sample_packed``) quantizes
    for name in sorted(grads):
        gi = grads[name]
        rows = kops.ef_sqnorm(gi.reshape(gi.shape[0], -1))
        # ∇_{a_i} f_i = N * row_i  ⇒  (1/N) Σ_i N²||row_i||² = N Σ_i ||row_i||²
        out[name] = float(n * torch.sum(rows))
    return out


def fisher_trace_exact(loss_fn: LossFn, params: Any, batch: Any
                       ) -> Dict[str, float]:
    """Exact EF trace from every per-sample gradient, each taken whole by
    ``torch.autograd.grad`` and reduced in plain fp32 (tests only)."""
    n = _batch_size(batch)
    leaves, p_grad = _grad_leaves(params)
    sq: Dict[str, list] = {name: [] for name in leaves}
    for i in range(n):
        grads = torch.autograd.grad(loss_fn(p_grad, _slice(batch, i, i + 1)),
                                    list(leaves.values()), allow_unused=True)
        for name, g in zip(leaves, grads):
            g32 = (torch.zeros_like(leaves[name]) if g is None else g
                   ).reshape(-1).to(torch.float32)
            sq[name].append(torch.sum(g32 * g32))
    return {k: float(torch.mean(torch.stack(v))) for k, v in sq.items()}
