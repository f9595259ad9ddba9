"""Step builders (port of ``repro.launch.steps``; the mesh's half ports
:36-56 and :120-292): QAT levels tables,
the one-device training step (``train_step``), and the (data, model)
mesh's sharded train, prefill and decode steps (``build_train_step``,
``build_prefill_step``, ``build_decode_step``, ``build_step``) with the
meta-tensor stand-ins of their inputs (``input_specs``).

A mesh step is single-controller: one process runs each data row in
turn (``models.context.MeshContext`` over the row's model shards, its
activations replicated on the row's lead shard) and the mesh's
collectives tie the rows together. ``place`` lays a tree out by a tree
of ``NamedSharding``s (as the reference's step functions place their
arguments by their input shardings); ``gather`` assembles it again.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.launch.mesh import gather, place  # noqa: F401  (re-exported)
from repro_torch.configs import ModelConfig
from repro_torch.models.transformer import (
    QATLevels, loss_fn, require_known_family)
from repro_torch.optim.adamw import AdamState, AdamWConfig, adamw_update
from repro_torch.quant.policy import BitConfig
from repro_torch.utils.pytree import map_with_names, named_leaves

OFF = 65535.0          # levels sentinel: the block stays unquantized


class TrainState(NamedTuple):
    params: Any
    opt: AdamState


def bitconfig_to_levels(cfg: ModelConfig, bits: BitConfig,
                        device: DeviceLike = None) -> QATLevels:
    """BitConfig (block path -> bits) to per-layer levels tables.

    Paths "layers/<i>/<rest>" become (L,) tensors keyed "<rest>"; other
    blocks stay scalars. A block missing from a layer's table is not
    quantized there (levels 2^16 − 1)."""
    dev = resolve_device(device)
    lw: Dict[str, np.ndarray] = {}
    la: Dict[str, np.ndarray] = {}
    tw: Dict[str, torch.Tensor] = {}
    ta: Dict[str, torch.Tensor] = {}

    def insert(table_layer, table_top, path, b):
        parts = path.split("/")
        lv = float(2 ** b - 1) if b < 16 else OFF
        if parts[0] == "layers" and len(parts) >= 3 and parts[1].isdigit():
            key = "/".join(parts[2:])
            arr = table_layer.setdefault(key, np.full(cfg.num_layers, OFF,
                                                      np.float32))
            arr[int(parts[1])] = lv
        else:
            table_top[path] = torch.tensor(lv, dtype=torch.float32, device=dev)

    for path, b in bits.weight_bits.items():
        insert(lw, tw, path, b)
    for path, b in bits.act_bits.items():
        insert(la, ta, path, b)
    return QATLevels({k: torch.from_numpy(v).to(dev) for k, v in lw.items()},
                     {k: torch.from_numpy(v).to(dev) for k, v in la.items()},
                     tw, ta)


def uniform_levels(cfg: ModelConfig, weight_bits: int,
                   act_bits: Optional[int], device: DeviceLike = None
                   ) -> QATLevels:
    """Uniform QAT levels over the standard per-layer blocks: every
    attention and MLP (or expert, or Mamba2 projection but ``wdt``) weight
    at ``weight_bits``; the attention output and the MLP hidden
    activation (the Mamba2 conv and SSD outputs) at ``act_bits`` (None:
    none). The audio and vlm families take the dense family's blocks. The
    hybrid gets empty tables: its blocks run unquantized under QAT, as in
    the reference."""
    require_known_family(cfg)
    dev = resolve_device(device)
    if cfg.family == "moe":
        wkeys = ["attn/wq", "attn/wk", "attn/wv", "attn/wo",
                 "moe/w_up", "moe/w_gate", "moe/w_down"]
        akeys = ["attn/attn_out", "moe/moe_h"]
    elif cfg.family == "ssm":
        wkeys = ["mixer/wz", "mixer/wx", "mixer/wB", "mixer/wC",
                 "mixer/out_proj"]
        akeys = ["mixer/conv_out", "mixer/ssd_out"]
    elif cfg.family == "hybrid":
        wkeys, akeys = [], []
    else:
        wkeys = ["attn/wq", "attn/wk", "attn/wv", "attn/wo",
                 "mlp/w_up", "mlp/w_down"] + (
                     ["mlp/w_gate"] if cfg.act == "swiglu" else [])
        akeys = ["attn/attn_out", "mlp/mlp_h"]
    ones = torch.ones((cfg.num_layers,), dtype=torch.float32, device=dev)
    lw = {k: ones * float(2 ** weight_bits - 1) for k in wkeys}
    la = {}
    if act_bits is not None:
        la = {k: ones * float(2 ** act_bits - 1) for k in akeys}
    return QATLevels(lw, la, {}, {})


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def train_step(state: TrainState, batch: Dict[str, Any], cfg: ModelConfig,
               adam: AdamWConfig, qat: Optional[QATLevels] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """loss_fn → backward → adamw_update. The params must require grad;
    they and the moments are updated in place. Metrics stay on the
    device: loss, lr, grad_norm."""
    leaves = named_leaves(state.params)
    loss = loss_fn(state.params, batch, cfg, qat=qat)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    by_name = {name: g for (name, _), g in zip(leaves, grads)}
    del grads
    gtree = map_with_names(lambda name, _: by_name[name], state.params)
    params, opt, metrics = adamw_update(adam, state.params, gtree, state.opt)
    return TrainState(params, opt), {"loss": loss.detach(), **metrics}


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def abstract_params(cfg: ModelConfig) -> Dict:
    """Meta tensors of the parameter tree's shapes and dtypes (nothing
    is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.transformer import init_params
    with FakeTensorMode():
        fake = init_params(cfg, device="cpu")
        shapes = map_with_names(lambda _, t: (tuple(t.shape), t.dtype), fake)
    return map_with_names(lambda _, sd: _meta(*sd), shapes,
                          is_leaf=lambda x: isinstance(x, tuple)
                          and len(x) == 2 and isinstance(x[1], torch.dtype))


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for one global batch (no allocation)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        tok_shape = (b, 1, cfg.num_codebooks) if cfg.family == "audio" else (b, 1)
        return {"tokens": _meta(tok_shape, i32)}
    if cfg.family == "audio":
        return {"tokens": _meta((b, s, cfg.num_codebooks), i32),
                "labels": _meta((b, s, cfg.num_codebooks), i32)}
    if cfg.family == "vlm":
        st = s - cfg.img_tokens
        return {"tokens": _meta((b, st), i32),
                "image_embed": _meta((b, cfg.img_tokens, cfg.d_model),
                                     cfg.param_dtype),
                "labels": _meta((b, s), i32)}
    return {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepBuild:
    fn: Any                       # the step function
    args: Tuple[Any, ...]         # meta-tensor stand-ins of its arguments
    rules: Any                    # models.partition.Rules
    shardings: Tuple[Any, ...] = ()   # where fn places each argument


def _rows(mesh, batch_ax) -> List[Tuple[Tuple[int, ...], List[Tuple[int, ...]]]]:
    """(lead, model group) of every batch shard: a lead's model group
    holds the shards whose parameter parts its forward reads. With the
    batch split over "model" (FSDP), every shard leads."""
    from repro_torch.launch.mesh import spec_axes
    coords = mesh.coords()
    if "model" not in mesh.shape:
        return [(c, [c]) for c in coords]
    groups = mesh.groups(coords, "model")
    if "model" in spec_axes(batch_ax):
        return [(c, g) for g in groups for c in g]
    return [(g[0], g) for g in groups]


# Told which row a step runs (``launch.dryrun``'s memory ledger): each is
# called with a row's lead as the row starts, and with None after the last.
ROW_OBSERVERS: List[Callable[[Optional[Tuple[int, ...]]], None]] = []


def _each_row(rows):
    """``rows`` in turn, every one of ``ROW_OBSERVERS`` told which runs."""
    for lead, group in rows:
        for obs in ROW_OBSERVERS:
            obs(lead)
        yield lead, group
    for obs in ROW_OBSERVERS:
        obs(None)


def _batch_slice(mesh, batch_ax, lead, batch: Dict[str, torch.Tensor]):
    if batch_ax is None:
        return batch
    n = mesh.axis_size(batch_ax)
    i = mesh.axis_index(batch_ax, lead)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {v.shape[0]} of {k!r} does not split "
                             f"over {batch_ax} ({n} shards)")
        step = v.shape[0] // n
        out[k] = v[i * step:(i + 1) * step]
    return out


def _row_tree(params, ctx, lead):
    """The parameter tree one row's forward reads: routed weight blocks
    as their lead part (``ctx`` computes with every shard's part), a
    D-sharded embedding as ``ShardedRows``, other leaves their lead part,
    or all-gathered when split."""
    from repro_torch.models.context import ROUTED, ShardedRows

    def one(name, st):
        tail = name.split("/")[-1]
        dim = ctx.model_dim(st)
        if tail in ROUTED or dim is None:
            return st.parts[lead]
        if tail == "embed" and dim == st.ndim - 1:
            return ShardedRows(ctx, {c: st.parts[c].to(ctx.mesh.device(c))
                                     for c in ctx.row})
        return ctx.mesh.all_gather({c: st.parts[c] for c in ctx.row}, "model",
                                   dim=dim)[lead]

    return map_with_names(one, params)


def _mesh_ctx(mesh, lead, params, opts, levels=None, scales=None, dtype=None):
    from repro_torch.models.context import MeshContext
    from repro_torch.serve.quantized import qw_path
    shards = {qw_path(name): st for name, st in named_leaves(params)}
    wl = al = None
    if levels is not None:
        wl, al = _flat_levels(levels)
    return MeshContext(mesh, lead, shards, strategy=opts.strategy,
                       weight_levels=wl, act_levels=al, scales=scales,
                       dtype=dtype)


def _flat_levels(qat: QATLevels):
    """QATLevels -> (weight, act) tables keyed by full block paths."""
    def flat(layer, top):
        out = dict(top)
        for key, lv in layer.items():
            for i in range(lv.shape[0]):
                out[f"layers/{i}/{key}"] = lv[i]
        return out
    return (flat(qat.layer_weights, qat.top_weights),
            flat(qat.layer_acts, qat.top_acts))


def _opt_shardings(mesh, p_sh, params, opts):
    from repro_torch.launch.mesh import NamedSharding, P
    from repro_torch.launch.sharding import opt_pspecs
    m_sh = opt_pspecs(p_sh, params, mesh, opts)
    return AdamState(step=NamedSharding(mesh, P()), m=m_sh, v=m_sh)


def build_train_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
                     opts=None, adam: AdamWConfig = AdamWConfig(),
                     qat: Optional[QATLevels] = None,
                     abstract: bool = True) -> StepBuild:
    """One sharded training step: ``fn(TrainState, batch) -> (TrainState,
    {"loss", "lr", "grad_norm"})``.

    Each data row runs ``loss_fn`` on its slice of the batch under its
    ``MeshContext`` (QAT levels applied shard by shard on the whole
    weight's grid) and takes its own backward; the loss reported is the
    rows' ``pmean``, ``loss_fn`` on the whole batch. A weight replicated
    over "model" is read by the row's lead shard, so its gradient is
    ``psum``'d over "model" (the other shards add zeros). Gradients are
    averaged over the data axes with ``pmean``, or, under
    ``grad_compression``, through ``optim.compression.ef_transform`` (the
    error-feedback residuals live with the step, one a shard, made at its
    first call) and ``compressed_psum``. AdamW then runs shard by shard
    with the gradient's global norm (``psum`` of the shards' sums of
    squares over "model"); under ``zero1`` the moments hold each shard's
    slice over the data axes (``launch.sharding.opt_pspecs``) and the
    updated slices are all-gathered. The state is placed on the first
    call (``place``) and updated in place."""
    from repro_torch.launch.sharding import (
        ShardOptions, data_axes, input_pspecs, make_rules, param_pspecs)
    from repro_torch.optim.adamw import init_adam
    opts = opts or ShardOptions()
    del abstract
    rules = make_rules(cfg, shape, mesh, opts)
    params = abstract_params(cfg)
    p_sh = param_pspecs(params, cfg, mesh, opts)
    o_sh = _opt_shardings(mesh, p_sh, params, opts)
    batch_ax = rules.table.get("batch")
    in_sh = input_pspecs(cfg, shape, mesh, batch_ax=batch_ax)
    specs = input_specs(cfg, shape)
    daxes = data_axes(mesh)
    ef_box: Dict[str, Any] = {}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        from repro_torch.models.partition import use_rules
        state = TrainState(place(state.params, p_sh), place(state.opt, o_sh))
        leaves = named_leaves(state.params)
        for _, st in leaves:
            for part in st.parts.values():
                if part.is_floating_point():
                    part.requires_grad_(True)
                    part.grad = None
        rows = _rows(mesh, batch_ax)
        share = {}
        for lead, group in rows:
            key = tuple(group)
            share[key] = share.get(key, 0) + 1
        losses = {}
        with use_rules(rules):
            for lead, group in _each_row(rows):
                ctx = _mesh_ctx(mesh, lead, state.params, opts, qat)
                inputs = {k: v.to(mesh.device(lead)) for k, v in
                          _batch_slice(mesh, batch_ax, lead, batch).items()}
                loss = loss_fn(_row_tree(state.params, ctx, lead), inputs, cfg,
                               ctx=ctx)
                w = 1.0 / share[tuple(group)]
                with mesh.recording(None):
                    (loss * w).backward()
                losses[lead] = loss.detach() * w
        grads = {name: {c: (p.grad if p.grad is not None else torch.zeros_like(p))
                        for c, p in st.parts.items()} for name, st in leaves}
        for _, st in leaves:
            for part in st.parts.values():
                part.grad = None
                part.requires_grad_(False)
        loss = _row_loss(mesh, rows, losses, daxes)
        grads = _sync_grads(mesh, leaves, grads, daxes, opts, ef_box)
        metrics = _sharded_adamw(mesh, adam, leaves, grads, state.opt, rows)
        return state, {"loss": loss, **metrics}

    return StepBuild(train_step,
                     (TrainState(params, init_adam(params)), specs), rules,
                     (TrainState(p_sh, o_sh), {k: in_sh[k] for k in specs}))


def _row_loss(mesh, rows, losses, daxes):
    """The global mean loss on the mesh's lead: each model group's
    (weighted) losses summed, then ``pmean``'d over the data axes."""
    by_group: Dict[Tuple, torch.Tensor] = {}
    for lead, group in rows:
        key = tuple(group)
        by_group[key] = by_group.get(key, 0.0) + losses[lead]
    parts = {}
    for key, v in by_group.items():
        for c in key:
            parts[c] = v.to(mesh.device(c))
    if daxes:
        parts = mesh.pmean(parts, daxes)
    return parts[mesh.origin]


def _sync_grads(mesh, leaves, grads, daxes, opts, ef_box):
    from repro_torch.optim.compression import compressed_psum, ef_transform, init_ef
    out = {}
    if opts.grad_compression and "ef" not in ef_box:
        ef_box["ef"] = {name: {c: init_ef(g) for c, g in gs.items()}
                        for name, gs in grads.items()}
    for name, st in leaves:
        g = grads[name]
        if "model" in mesh.shape and st.axis_dim("model") is None:
            # rpr-ok: RPR002 one nonzero operand (the lead's gradient) and zeros: fp adds of zeros are exact
            g = mesh.psum(g, "model")
        if daxes:
            if opts.grad_compression:
                efs = ef_box["ef"][name]
                pairs = {c: ef_transform(g[c], efs[c]) for c in g}
                for c, (_, e) in pairs.items():
                    efs[c] = e
                g = compressed_psum({c: d for c, (d, _) in pairs.items()},
                                    mesh, daxes)
            else:
                g = mesh.pmean(g, daxes)
        out[name] = g
    return out


@torch.no_grad()
def _sharded_adamw(mesh, cfg: AdamWConfig, leaves, grads, opt: AdamState,
                   rows) -> Dict[str, torch.Tensor]:
    """``optim.adamw.adamw_update``, shard by shard and in place: the
    global norm from every shard's sum of squares (a weight replicated
    over "model" counted once) ``psum``'d over "model"; moments split
    over the data axes (ZeRO-1) update their slice, and the updated
    parameter slices are all-gathered."""
    from repro_torch.launch.mesh import spec_axes
    from repro_torch.optim.adamw import schedule_lr

    coords = mesh.coords()
    m_leaves = dict(named_leaves(opt.m))
    v_leaves = dict(named_leaves(opt.v))
    sq = {}
    for c in coords:
        owner = "model" not in mesh.shape or c[mesh.axis_names.index("model")] == 0
        terms = [torch.sum(torch.square(grads[name][c].to(torch.float32)))
                 for name, st in leaves if owner or st.axis_dim("model") is not None]
        sq[c] = torch.sum(torch.stack(terms))
    if "model" in mesh.shape:
        # rpr-ok: RPR002 training-path fp32 sums of squares, folded in shard order
        sq = mesh.psum(sq, "model")
    norm = {c: torch.sqrt(v) for c, v in sq.items()}
    scale = ({c: torch.clamp_max(cfg.clip_norm / torch.clamp_min(n, 1e-9), 1.0)
              for c, n in norm.items()} if cfg.clip_norm is not None else None)
    step_parts = opt.step.parts
    step = step_parts[mesh.origin] + 1
    for p in step_parts.values():
        p.add_(1)
    lr = schedule_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    for name, st in leaves:
        m_st, v_st = m_leaves[name], v_leaves[name]
        zdim = next((i for i, (a, b) in enumerate(zip(
            tuple(m_st.sharding.spec) + (None,) * st.ndim,
            tuple(st.sharding.spec) + (None,) * st.ndim)) if a != b), None)
        new = {}
        for c, p in st.parts.items():
            d = p.device
            g = grads[name][c]
            if scale is not None:
                g = (g.to(torch.float32) * scale[c].to(d)).to(g.dtype)
            g32 = g.to(torch.float32)
            m, v = m_st.parts[c], v_st.parts[c]
            rel = _relative(m_st.sharding, st.sharding, st.shape, c)
            g32, p_sl = g32[rel], p[rel]
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g32)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g32))
            delta = (m / b1c.to(d)) / (torch.sqrt(v / b2c.to(d)) + cfg.eps) \
                + cfg.weight_decay * p_sl.to(torch.float32)
            new[c] = (p_sl.to(torch.float32) - lr.to(d) * delta).to(p.dtype)
        if zdim is not None:
            axes = spec_axes(tuple(m_st.sharding.spec)[zdim])
            new = mesh.all_gather(new, axes, dim=zdim)
        for c, p in st.parts.items():
            p.copy_(new[c])
    return {"lr": lr, "grad_norm": norm[mesh.origin]}


def _relative(inner, outer, shape, c) -> Tuple[slice, ...]:
    """Shard c's slice of ``inner``'s layout within its ``outer`` part."""
    a = inner.slices(shape, c)
    b = outer.slices(shape, c)
    return tuple(slice(x.start - y.start, x.stop - y.start) for x, y in zip(a, b))


def build_prefill_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
                       opts=None) -> StepBuild:
    """Prefill = the full-sequence forward's logits (serving ingest):
    ``fn(params, batch)`` -> a ``ShardedTensor`` of logits laid out over
    the batch axes (``.full()`` assembles them)."""
    from repro_torch.launch.sharding import (
        ShardOptions, input_pspecs, make_rules, param_pspecs)
    from repro_torch.models.partition import use_rules
    from repro_torch.models.transformer import forward
    opts = opts or ShardOptions()
    rules = make_rules(cfg, shape, mesh, opts)
    params = abstract_params(cfg)
    p_sh = param_pspecs(params, cfg, mesh, opts)
    in_sh = input_pspecs(cfg, shape, mesh)
    specs = input_specs(cfg, shape)
    specs.pop("labels", None)
    batch_ax = rules.table.get("batch")

    @torch.no_grad()
    def prefill_step(params, batch):
        params = place(params, p_sh)
        rows = _rows(mesh, batch_ax)
        outs = {}
        with use_rules(rules):
            for lead, group in _each_row(rows):
                ctx = _mesh_ctx(mesh, lead, params, opts)
                inputs = {k: v.to(mesh.device(lead)) for k, v in
                          _batch_slice(mesh, batch_ax, lead, batch).items()}
                outs[lead] = forward(_row_tree(params, ctx, lead), inputs, cfg,
                                     ctx=ctx)[0]
        return _batch_sharded(mesh, rows, outs, batch_ax)

    return StepBuild(prefill_step, (params, specs), rules,
                     (p_sh, {k: in_sh[k] for k in specs}))


def _batch_sharded(mesh, rows, outs, batch_ax):
    """Per-row outputs as one tensor laid out over the batch axes."""
    from repro_torch.launch.mesh import NamedSharding, P, ShardedTensor
    first = next(iter(outs.values()))
    parts = {}
    for lead, group in rows:
        for c in group:
            if c == lead or c not in parts:
                parts[c] = outs[lead].to(mesh.device(c))
    n = mesh.axis_size(batch_ax) if batch_ax is not None else 1
    shape = (first.shape[0] * n,) + tuple(first.shape[1:])
    spec = P(batch_ax, *([None] * (first.ndim - 1)))
    return ShardedTensor(NamedSharding(mesh, spec), parts, shape)


_DECODE_SKIP = ("norm", "ln", "conv", "a_log", "dt_bias", "router", "embed")


def _decode_key(name: str) -> str:
    key = "/".join(p for p in name.split("/") if not p.isdigit())
    return key.replace("layers/", "").replace("groups/", "").replace(
        "rest/", "").replace("shared/", "")


def _quantize_decode(params: Any):
    """(int8 tree, scales by the reference's key). A block's scale is
    amax/127 over the leaves of every layer (the reference's stacked
    leaf); a later block of the same key overwrites its scale, as
    there."""
    stacked: Dict[str, List[Tuple[str, Any]]] = {}
    for name, leaf in named_leaves(params):
        if leaf.ndim < 2 or any(sk in name.lower() for sk in _DECODE_SKIP):
            continue
        sname = "/".join(p for p in name.split("/") if not p.isdigit())
        stacked.setdefault(sname, []).append((name, leaf))
    scales: Dict[str, torch.Tensor] = {}
    out: Dict[str, torch.Tensor] = {}
    for sname, members in stacked.items():
        key = _decode_key(sname)
        if members[0][1].device.type == "meta":
            s = torch.tensor(0.01, dtype=torch.float32)
            for name, leaf in members:
                out[name] = _meta(leaf.shape, torch.int8)
        else:
            amax = torch.amax(torch.stack([
                torch.amax(torch.abs(leaf.to(torch.float32)))
                for _, leaf in members]))
            s = (torch.clamp_min(amax, 1e-9) / 127.0).to(torch.float32)
            for name, leaf in members:
                out[name] = torch.clamp(torch.round(leaf.to(torch.float32) / s),
                                        -127, 127).to(torch.int8)
        scales[key] = s
    qparams = map_with_names(lambda name, leaf: out.get(name, leaf), params)
    return qparams, scales


def quantize_decode_params(params: Any, cfg: ModelConfig):
    """Params (or meta tensors) -> int8 matmul weights and per-block
    fp32 scales keyed by the within-layer path (serving PTQ). Matmul
    weights (>= 2-D; not norms, convs, ssm scalars, the router or the
    embedding) are quantized symmetrically; meta leaves just change dtype
    (scale 0.01)."""
    del cfg
    return _quantize_decode(params)


def _state_names(state) -> List[Tuple[str, Any]]:
    """(path, leaf) of a DecodeState's tensors, by field name."""
    out = []
    for f in state._fields:
        v = getattr(state, f)
        if v is None:
            continue
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out.extend((f"{f}/{g}", getattr(v, g)) for g in v._fields)
        else:
            out.append((f, v))
    return out


def decode_state_pspecs(state, cfg: ModelConfig, shape: ShapeSpec, mesh,
                        opts, rules):
    """Shardings for a DecodeState: caches batch over data, kv heads or
    cache positions over model; SSM states batch over data, heads over
    model."""
    from repro_torch.launch.mesh import NamedSharding, P
    b_ax = rules.table.get("batch")
    kv_ax = rules.table.get("kv_heads")
    seq_ax = rules.table.get("cache_seq")
    model_sz = mesh.shape.get("model", 1)

    def spec_for(name: str, leaf) -> NamedSharding:
        nd = len(leaf.shape)
        if name.endswith("pos"):
            return NamedSharding(mesh, P())
        if name.split("/")[0] == "kv":
            # (G?, B, T, KV, Dh)
            spec = [None] * nd
            spec[nd - 4] = b_ax
            if kv_ax is not None:
                spec[nd - 2] = kv_ax
            elif seq_ax is not None:
                spec[nd - 3] = seq_ax
            return NamedSharding(mesh, P(*spec))
        if name.endswith("/h"):
            # (..., B, H, N, P)
            spec = [None] * nd
            spec[nd - 4] = b_ax
            if cfg.ssm_heads % model_sz == 0:
                spec[nd - 3] = "model"
            return NamedSharding(mesh, P(*spec))
        if name.endswith("/conv"):
            spec = [None] * nd
            spec[nd - 3] = b_ax
            return NamedSharding(mesh, P(*spec))
        return NamedSharding(mesh, P(*([None] * nd)))

    specs = dict((n, spec_for(n, leaf)) for n, leaf in _state_names(state))
    fields = []
    for f in state._fields:
        v = getattr(state, f)
        if v is None:
            fields.append(None)
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            fields.append(type(v)(*(specs[f"{f}/{g}"] for g in v._fields)))
        else:
            fields.append(specs[f])
    return type(state)(*fields)


def _kv_mode(st) -> str:
    dim = st.axis_dim("model")
    if dim is None:
        return "repl"
    return "heads" if dim == st.ndim - 2 else "seq"


def _row_ssm(mesh, group, lead, st):
    """A row's SSM state (a ``MambaState`` of ``ShardedTensor``s) whole on
    its lead: ``h``'s head parts all-gathered over "model" where split,
    the lead's own part otherwise (updated in place there)."""
    from repro_torch.models.mamba2 import MambaState

    def one(t):
        dim = t.axis_dim("model")
        if dim is None:
            return t.parts[lead]
        return mesh.all_gather({c: t.parts[c] for c in group}, "model",
                               dim=dim)[lead]

    return MambaState(*(one(t) for t in st))


def _write_ssm(mesh, group, st, row) -> None:
    """Each shard of ``group`` takes its slice of the row's advanced state
    ``row`` into its part of ``st``, in place."""
    for t, new in zip(st, row):
        dim = t.axis_dim("model")
        for i, c in enumerate(group):
            part = t.parts[c]
            src = new if dim is None else new.narrow(dim, i * part.shape[dim],
                                                     part.shape[dim])
            if src is not part:
                part.copy_(src.to(mesh.device(c)))


def build_decode_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
                      opts=None) -> StepBuild:
    """One-token serve step with a ``seq_len``-deep dense KV cache:
    ``fn(params, state, tokens, scales=None) -> (logits, state)``.

    Each data row decodes its slots under its ``MeshContext``; the cache
    is laid out by ``decode_state_pspecs`` (``models.attention.ShardedKV``):
    kv heads over "model" where they divide (each shard reads its heads
    through the paged kernel), else with ``shard_cache_seq`` the
    positions (softmax partials combined across shards). ``decode_quant``
    "w8" takes int8 weights (``quantize_decode_params``), "w8kv8" also an
    int8 cache on the static ``attention.KV_SCALE`` grid. Like the
    reference, the step dequantizes with the scales of the builder's
    abstract quantization (0.01 a block) unless ``scales`` (the second
    result of ``quantize_decode_params`` on the real params) is given.

    The ssm and hybrid families keep their SSM state as the reference
    lays it out: ``h`` with its batch over the data axes and its heads
    over "model" where they divide, ``conv`` with its batch over the
    data axes. A row's activations are replicated on its lead, so the
    recurrence runs there: the row's ``h`` parts are all-gathered onto
    the lead, ``decode_step`` advances the row's whole state, and each
    shard's heads are written back into its part in place (as ``pos``
    is). The hybrid's shared-attention cache follows the dense rules
    (``ShardedKV``); "kv8" quantizes that cache only, the SSM states stay
    fp32."""
    from repro_torch.launch.mesh import NamedSharding, P
    from repro_torch.launch.sharding import ShardOptions, make_rules, param_pspecs
    from repro_torch.models.attention import KVCache, ShardedKV
    from repro_torch.models.decode import DecodeState, decode_step, init_decode_state
    from repro_torch.models.partition import use_rules
    opts = opts or ShardOptions()
    rules = make_rules(cfg, shape, mesh, opts)
    params = abstract_params(cfg)
    key_scales = None
    if opts.decode_quant:
        params, key_scales = _quantize_decode(params)
    p_sh = param_pspecs(params, cfg, mesh, opts)
    kv8 = bool(opts.decode_quant and "kv8" in opts.decode_quant)
    state = init_decode_state(cfg, shape.global_batch, shape.seq_len,
                              device="meta",
                              kv_dtype=torch.int8 if kv8 else None)
    s_sh = decode_state_pspecs(state, cfg, shape, mesh, opts, rules)
    specs = input_specs(cfg, shape)
    batch_ax = rules.table.get("batch")
    tok_sh = NamedSharding(mesh, P(batch_ax, *(None,) * (specs["tokens"].ndim - 1)))

    @torch.no_grad()
    def serve_step(params, state, tokens, scales=None):
        params = place(params, p_sh)
        state = place(state, s_sh)
        sc = None
        if opts.decode_quant:
            from repro_torch.serve.quantized import qw_path
            table = scales if scales is not None else key_scales
            sc = {qw_path(name): table[_decode_key(name)]
                  for name, st in named_leaves(params)
                  if st.dtype == torch.int8 and _decode_key(name) in table}
        rows = _rows(mesh, batch_ax)
        outs = {}
        with use_rules(rules):
            for lead, group in _each_row(rows):
                ctx = _mesh_ctx(mesh, lead, params, opts, scales=sc,
                                dtype=cfg.param_dtype)
                kv = None
                if state.kv is not None:
                    mode = _kv_mode(state.kv.k)
                    kv = KVCache(*(ShardedKV(mesh, group, lead,
                                             {c: t.parts[c] for c in group}, mode)
                                   for t in state.kv))
                ssm = {f: _row_ssm(mesh, group, lead, getattr(state, f))
                       for f in ("ssm", "rest") if getattr(state, f) is not None}
                row_state = DecodeState(pos=state.pos.parts[lead], kv=kv, **ssm)
                tok = _batch_slice(mesh, batch_ax, lead, {"t": tokens})["t"]
                logits, new = decode_step(_row_tree(params, ctx, lead), row_state,
                                          tok.to(mesh.device(lead)), cfg, ctx=ctx)
                for c in group:
                    state.pos.parts[c].copy_(new.pos.to(mesh.device(c)))
                for f, row in ssm.items():
                    _write_ssm(mesh, group, getattr(state, f), row)
                outs[lead] = logits
        return _batch_sharded(mesh, rows, outs, batch_ax), state

    return StepBuild(serve_step, (params, state, specs["tokens"]), rules,
                     (p_sh, s_sh, tok_sh))


def build_step(cfg: ModelConfig, shape: ShapeSpec, mesh, opts=None,
               qat: Optional[QATLevels] = None) -> StepBuild:
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, opts, qat=qat)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, opts)
    return build_decode_step(cfg, shape, mesh, opts)
