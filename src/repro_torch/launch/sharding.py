"""Sharding rules: logical-axis tables and parameter partition specs per
architecture (port of ``repro.launch.sharding``, :1-242; every
function takes the reference's inputs and returns its specs).

Strategy:
  DP  over ("pod", "data")  — batch dim of inputs/activations.
  TP  over "model"          — Megatron column→row pairs, a vocab-sharded
                              head and a D-sharded embedding,
                              expert-hidden (MoE-TP) or expert axis
                              (MoE-EP), SSM projections.
  SP  over "model"          — the residual stream's seq dim in the
                              table (``seq_parallel``); the port keeps
                              activations replicated within a data row,
                              so it changes nothing here
                              (``models.partition``).
  EP  over "model"          — the MoE expert axis (``moe.moe_apply_ep``).

Every rule is divisibility-guarded: a dim that does not divide by the
mesh axis stays replicated (e.g. minitron's 24 heads on a 16-way model
axis; the MLP still shards).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.configs import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import Mesh, NamedSharding, PartitionSpec as P
from repro_torch.models.partition import Rules
from repro_torch.utils.pytree import map_with_names, named_leaves


@dataclasses.dataclass(frozen=True)
class ShardOptions:
    """Distribution knobs."""
    strategy: str = "tp"                # "tp" (Megatron) | "fsdp" (ZeRO-3)
    seq_parallel: bool = True           # SP on the residual stream (tp only)
    moe_mode: str = "ep"                # "ep" | "tp"
    zero1: bool = False                 # shard optimizer moments over data
    shard_cache_seq: bool = True        # decode: shard KV-cache seq when kv-heads can't
    grad_compression: bool = False      # int8 DP all-reduce with error feedback
    decode_quant: Optional[str] = None  # None | "w8" | "w8kv8" (serving PTQ)


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        return int(np.prod([mesh.shape.get(n, 1) for n in name]))
    return mesh.shape.get(name, 1)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def make_rules(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
               opts: ShardOptions = ShardOptions()) -> Rules:
    """Activation-constraint table for (arch × shape × mesh). Reads only
    ``mesh.shape``."""
    model_sz = mesh.shape.get("model", 1)
    batch_ax = data_axes(mesh)
    d_batch = _axis_size(mesh, batch_ax)

    def fits(n: int, ax):
        if ax is not None and (ax not in mesh.shape if isinstance(ax, str) else False):
            return None
        return ax if ax is not None and n % _axis_size(mesh, ax) == 0 else None

    heads_ax = fits(cfg.num_heads or 1, "model")
    kv_ax = fits(cfg.num_kv_heads or 1, "model")
    has_model = "model" in mesh.shape

    if opts.strategy == "fsdp" and has_model and shape.kind != "decode":
        # FSDP/ZeRO-3: every shard is a data shard; weights live sharded
        # over "model" (the TP specs) and are all-gathered at use
        full_batch_ax = batch_ax + ("model",) if batch_ax else ("model",)
        fb = shape.global_batch % _axis_size(mesh, full_batch_ax) == 0
        return Rules(mesh, {
            "batch": full_batch_ax if fb else batch_ax,
            "seq": "model" if not fb and shape.seq_len % model_sz == 0 else None,
            "seq_noshard": None, "heads": None, "kv_heads": None,
            "vocab": "model", "experts": None, "expert_ff": None,
            "cache_seq": None,
        })

    table: Dict[str, Any] = {
        "batch": batch_ax if batch_ax and shape.global_batch % d_batch == 0 else None,
        "seq": "model" if has_model and opts.seq_parallel
               and shape.kind != "decode"
               and shape.seq_len % model_sz == 0 else None,
        "seq_noshard": None,
        "heads": heads_ax,
        "kv_heads": kv_ax,
        "vocab": "model" if has_model else None,
        "experts": fits(cfg.num_experts or 1, "model") if opts.moe_mode == "ep" else None,
        "expert_ff": fits(cfg.d_ff or 1, "model") if opts.moe_mode == "tp" else None,
        # decode KV cache: shard seq over model if kv heads can't shard
        "cache_seq": ("model" if (has_model and opts.shard_cache_seq
                                  and kv_ax is None
                                  and shape.seq_len % model_sz == 0)
                      else None) if shape.kind == "decode" else None,
    }
    return Rules(mesh, table)


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------

_COL = ("w_up", "w_gate", "wz", "wx", "wB", "wC", "wdt")     # shard output dim
_ROW = ("wo", "w_down", "out_proj")                          # shard input dim
_REPL = ("ln1", "ln2", "ln", "final_norm", "norm_w", "conv_w", "conv_b",
         "A_log", "D", "dt_bias", "router")


def _param_spec(name: str, shape: Tuple[int, ...], cfg: ModelConfig,
                mesh: Mesh, opts: ShardOptions) -> P:
    if "model" not in mesh.shape:
        return P(*([None] * len(shape)))
    model_sz = mesh.shape["model"]
    tail = name.split("/")[-1]
    nd = len(shape)

    def ok(dim_idx: int) -> bool:
        return shape[dim_idx] % model_sz == 0

    spec = [None] * nd
    if tail == "embed":
        # (V, D) or (CB, V, D): shard the embed dim, so each shard looks up
        # its slice and the (B, S, D/m) slices are gathered
        if ok(nd - 1):
            spec[nd - 1] = "model"
    elif tail == "head":
        if ok(nd - 1):
            spec[nd - 1] = "model"
    elif tail in _REPL:
        pass
    elif tail == "wq":
        # out dim is H·Dh; only shard if the head reshape stays aligned
        if (cfg.num_heads or 1) % model_sz == 0 and ok(nd - 1):
            spec[nd - 1] = "model"
    elif tail in ("wk", "wv"):
        if (cfg.num_kv_heads or 1) % model_sz == 0 and ok(nd - 1):
            spec[nd - 1] = "model"
    elif tail == "wo":
        if (cfg.num_heads or 1) % model_sz == 0 and ok(nd - 2):
            spec[nd - 2] = "model"
    elif tail in _COL:
        if ok(nd - 1):
            spec[nd - 1] = "model"
    elif tail in _ROW:
        if ok(nd - 2):
            spec[nd - 2] = "model"
    if opts.strategy == "fsdp" and all(s is None for s in spec) and nd >= 2:
        # FSDP has no activation-alignment constraint: a weight the TP
        # rules left replicated shards on its largest divisible dim
        dims = sorted(range(nd), key=lambda i: -shape[i])
        for i in dims:
            if shape[i] % model_sz == 0 and shape[i] >= model_sz:
                spec[i] = "model"
                break
    return P(*spec)


def _moe_expert_spec(tail: str, shape: Tuple[int, ...], cfg: ModelConfig,
                     mesh: Mesh, opts: ShardOptions) -> P:
    """Expert tensors (..., E, d_in, d_out)."""
    if "model" not in mesh.shape:
        return P(*([None] * len(shape)))
    model_sz = mesh.shape["model"]
    nd = len(shape)
    spec = [None] * nd
    if opts.moe_mode == "ep" and shape[nd - 3] % model_sz == 0:
        spec[nd - 3] = "model"
    elif opts.moe_mode == "tp":
        ff_dim = nd - 1 if tail in ("w_up", "w_gate") else nd - 2
        if shape[ff_dim] % model_sz == 0:
            spec[ff_dim] = "model"
    return P(*spec)


def _leaf_spec(name: str, shape: Tuple[int, ...], cfg: ModelConfig,
              mesh: Mesh, opts: ShardOptions = ShardOptions()) -> P:
    """The partition spec of the parameter leaf at path ``name``."""
    tail = name.split("/")[-1]
    parts = name.split("/")
    if len(parts) >= 2 and parts[-2] == "moe" and tail in ("w_up", "w_gate", "w_down"):
        return _moe_expert_spec(tail, tuple(shape), cfg, mesh, opts)
    if "moe/shared" in name:
        return _param_spec("/".join(parts[-1:]), tuple(shape), cfg, mesh, opts)
    return _param_spec(name, tuple(shape), cfg, mesh, opts)


def param_pspecs(params_tree: Any, cfg: ModelConfig, mesh: Mesh,
                 opts: ShardOptions = ShardOptions()) -> Any:
    """``NamedSharding`` tree for params (or meta tensors of their
    shapes)."""
    return map_with_names(
        lambda name, leaf: NamedSharding(
            mesh, _leaf_spec(name, tuple(leaf.shape), cfg, mesh, opts)),
        params_tree)


def opt_pspecs(params_shardings: Any, params_tree: Any, mesh: Mesh,
               opts: ShardOptions) -> Any:
    """Moment shardings: the params' specs, plus ZeRO-1 data-sharding of
    the first replicated dim that divides when enabled."""
    if not opts.zero1:
        return params_shardings
    daxes = data_axes(mesh)
    dsz = _axis_size(mesh, daxes)
    shapes = {name: tuple(leaf.shape) for name, leaf in named_leaves(params_tree)}

    def one(name: str, sharding: NamedSharding) -> NamedSharding:
        shape = shapes[name]
        spec = list(sharding.spec) + [None] * (len(shape) - len(sharding.spec))
        for i, (dim, cur) in enumerate(zip(shape, spec)):
            if cur is None and dim % dsz == 0 and dim >= dsz:
                spec[i] = daxes if len(daxes) > 1 else daxes[0]
                break
        return NamedSharding(mesh, P(*spec))

    return map_with_names(one, params_shardings,
                          is_leaf=lambda x: isinstance(x, NamedSharding))


def input_pspecs(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
                 batch_ax=None) -> Dict[str, NamedSharding]:
    if batch_ax is None:
        daxes = data_axes(mesh)
        ok = shape.global_batch % _axis_size(mesh, daxes) == 0
        b_ax = daxes if ok else None
    else:
        b_ax = batch_ax
    tok = NamedSharding(mesh, P(b_ax, None, None) if cfg.family == "audio"
                        else P(b_ax, None))
    out = {"tokens": tok, "labels": NamedSharding(
        mesh, P(b_ax, None, None) if cfg.family == "audio" else P(b_ax, None))}
    if cfg.family == "vlm":
        out["image_embed"] = NamedSharding(mesh, P(b_ax, None, None))
    return out
