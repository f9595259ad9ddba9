"""Decode-state containers and one-token decode steps (port of
``repro.models.decode``), dense and MoE families.

Dense state: a KVCache stacked (L, B, T, KV, Dh) plus positions; paged
state: per-layer page pools + page table (``kvcache.PagedState``).
``pos`` is a () scalar or a (B,) per-slot vector (the serving engine).
Caches are written in place; the returned state holds the same tensors.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models.attention import KVCache
from repro_torch.models.context import ColumnContext, Context
from repro_torch.models.transformer import (
    _attn_mlp_block_decode, _attn_mlp_block_decode_paged, column_rmsnorm,
    logits_from_hidden, require_ported_family)


class DecodeState(NamedTuple):
    pos: torch.Tensor                     # () or (B,) int32 — current length
    kv: Optional[KVCache] = None          # dense caches (L, B, T, KV, Dh)
    paged: Optional[Any] = None           # kvcache.PagedState (else dense kv)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      per_slot_pos: bool = False, device=None,
                      kv_dtype: Optional[torch.dtype] = None) -> DecodeState:
    """Zeroed dense caches on ``device`` (default: the GPU) in the model
    dtype, or ``kv_dtype=torch.int8`` for the static-scale int8 cache
    (``attention.KV_SCALE``)."""
    require_ported_family(cfg)
    dev = resolve_device(device)
    pshape = (batch,) if per_slot_pos else ()
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dt = kv_dtype or cfg.param_dtype
    return DecodeState(
        pos=torch.zeros(pshape, dtype=torch.int32, device=dev),
        kv=KVCache(torch.zeros(shape, dtype=dt, device=dev),
                   torch.zeros(shape, dtype=dt, device=dev)))


def init_paged_decode_state(cfg: ModelConfig, pcfg, batch: int,
                            ranges: Optional[Mapping] = None,
                            device=None, mesh=None) -> DecodeState:
    """``mesh``: a TPMesh to shard the pools over by kv head."""
    from repro_torch.kvcache.paged import init_paged_kv
    require_ported_family(cfg)
    dev = resolve_device(device)
    return DecodeState(pos=torch.zeros((batch,), dtype=torch.int32, device=dev),
                       paged=init_paged_kv(cfg, pcfg, batch, ranges, device=dev,
                                           mesh=mesh))


def decode_step(params, state: DecodeState, tokens: torch.Tensor,
                cfg: ModelConfig, ctx: Optional[Context] = None
                ) -> Tuple[torch.Tensor, DecodeState]:
    """Decode tokens (B, T) -> logits (B, T, V). ``ctx`` hooks weight
    access (e.g. ``DequantContext`` for packed serving).

    T > 1 (the speculative verify and the draft's catch-up) is bitwise T
    sequential one-token steps, logits and cache: every K/V row is
    written, then each query column reads under its own mask; the ops
    whose bits may depend on the row count (a library GEMM, rmsnorm's
    mean, MoE routing and capacity) run one call a column at the
    one-token shape (``ColumnContext``), and only the row-exact integer
    kernels see all B·T rows in one call."""
    require_ported_family(cfg)
    ctx = ctx or Context()
    x = params["embed"][tokens.long()].to(cfg.param_dtype)
    tq = x.shape[1]
    if tq > 1:
        ctx = ColumnContext(ctx)
    pos = state.pos
    if state.paged is not None:
        ps = state.paged
        for i in range(cfg.num_layers):
            with ctx.scope(f"layers/{i}"):
                x, _ = _attn_mlp_block_decode_paged(
                    x, params["layers"][str(i)], cfg, ctx, ps.layers[str(i)],
                    ps.table, pos, ps.write_limit)
        new_state = DecodeState(pos=pos + tq, paged=ps)
    else:
        for i in range(cfg.num_layers):
            ci = KVCache(state.kv.k[i], state.kv.v[i])
            with ctx.scope(f"layers/{i}"):
                x, _ = _attn_mlp_block_decode(x, params["layers"][str(i)],
                                              cfg, ctx, ci, pos)
        new_state = DecodeState(pos=pos + tq, kv=state.kv)
    if tq == 1:
        return logits_from_hidden(params, x, cfg, ctx), new_state
    x = column_rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return ctx.matmul("head", x, params["head"]), new_state


def prefill_into(params, state: DecodeState, tokens: torch.Tensor,
                 cfg: ModelConfig, ctx: Optional[Context] = None
                 ) -> Tuple[torch.Tensor, DecodeState]:
    """Continue a decode state over a span of tokens (B, C): a loop of
    one-token ``decode_step`` calls — exact decode numerics. Returns the
    per-position logits (B, C, V) and the advanced state."""
    out = []
    for c in range(tokens.shape[1]):
        logits, state = decode_step(params, state, tokens[:, c:c + 1], cfg,
                                    ctx=ctx)
        out.append(logits[:, 0])
    return torch.stack(out, dim=1), state


def prefill(params, inputs: Mapping[str, torch.Tensor], cfg: ModelConfig,
            max_len: int, ctx: Optional[Context] = None
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Run the whole prompt ``inputs["tokens"]`` (B, S) from an empty
    dense state of ``max_len`` positions on the tokens' device: the
    per-position logits (B, S, V) and the filled state, through
    ``prefill_into`` (exact decode numerics)."""
    tokens = inputs["tokens"]
    state = init_decode_state(cfg, tokens.shape[0], max_len,
                              device=tokens.device)
    return prefill_into(params, state, tokens, cfg, ctx=ctx)


def state_insert_slot(cfg: ModelConfig, state: DecodeState,
                      sub: DecodeState, slot: int) -> DecodeState:
    """Write a batch-1 dense state ``sub`` into row ``slot`` of a batched
    dense state (in place)."""
    state.pos[slot] = sub.pos.reshape(())
    state.kv.k[:, slot] = sub.kv.k[:, 0]
    state.kv.v[:, slot] = sub.kv.v[:, 0]
    return state
