"""Decode-state containers and one-token decode steps (port of
``repro.models.decode``), for every family.

State layouts (leading layer dims before the batch):

  dense / moe / audio / vlm : a KVCache (L, B, T, KV, Dh) x 2 — or,
                paged, per-layer page pools + page table
                (``kvcache.PagedState``);
  ssm         : a MambaState (L, B, H, N, P) fp32 + conv tails
                (L, B, W-1, C) in the param dtype;
  hybrid      : MambaStates (G, period, B, ...) and the remainder's
                (R, B, ...), plus the shared block's KV, one cache (or
                pool) a group application (G, B, T, KV, Dh).

``pos`` is a () scalar or a (B,) per-slot vector (the serving engine).
Caches and SSM states are written in place; the returned state holds
the same tensors. The audio family's tokens are (B, T, CB) grids and its
logits (B, T, CB, V); the vlm family's ``prefill`` ingests the image
patches through ``decode_step(..., embed=...)`` a position at a time
before the text.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models.attention import KVCache
from repro_torch.models.context import ColumnContext, Context
from repro_torch.models.mamba2 import MambaState
from repro_torch.models.transformer import (
    _attn_mlp_block_decode, _attn_mlp_block_decode_paged, _mamba_block_decode,
    column_rmsnorm, embed_tokens, logits_from_hidden, require_known_family,
    split_codebooks)


class DecodeState(NamedTuple):
    pos: torch.Tensor                     # () or (B,) int32 — current length
    kv: Optional[KVCache] = None          # dense caches (L, B, T, KV, Dh)
    ssm: Optional[MambaState] = None      # mamba states (stacked)
    rest: Optional[MambaState] = None     # hybrid remainder layers
    paged: Optional[Any] = None           # kvcache.PagedState (else dense kv)


def _ssm_struct(cfg: ModelConfig, lead: Tuple[int, ...], b: int,
                device) -> MambaState:
    return MambaState.zeros(b, cfg, cfg.param_dtype, device, lead)


def _ssm_states(cfg: ModelConfig, b: int, device) -> dict:
    """The ssm and rest states of a recurrent family (empty otherwise)."""
    if cfg.family == "ssm":
        return {"ssm": _ssm_struct(cfg, (cfg.num_layers,), b, device)}
    if cfg.family == "hybrid":
        n_groups, rem = divmod(cfg.num_layers, cfg.attn_period)
        return {"ssm": _ssm_struct(cfg, (n_groups, cfg.attn_period), b, device),
                "rest": _ssm_struct(cfg, (rem,), b, device) if rem else None}
    return {}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      per_slot_pos: bool = False, device=None,
                      kv_dtype: Optional[torch.dtype] = None) -> DecodeState:
    """Zeroed dense caches (and SSM states) on ``device`` (default: the
    GPU), the caches in the model dtype, or ``kv_dtype=torch.int8`` for
    the static-scale int8 cache (``attention.KV_SCALE``)."""
    from repro_torch.kvcache.paged import kv_layer_count
    require_known_family(cfg)
    dev = resolve_device(device)
    pshape = (batch,) if per_slot_pos else ()
    pos = torch.zeros(pshape, dtype=torch.int32, device=dev)
    n_kv = kv_layer_count(cfg)
    kv = None
    if n_kv:
        shape = (n_kv, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        dt = kv_dtype or cfg.param_dtype
        kv = KVCache(torch.zeros(shape, dtype=dt, device=dev),
                     torch.zeros(shape, dtype=dt, device=dev))
    return DecodeState(pos=pos, kv=kv, **_ssm_states(cfg, batch, dev))


def init_paged_decode_state(cfg: ModelConfig, pcfg, batch: int,
                            ranges: Optional[Mapping] = None,
                            device=None, mesh=None) -> DecodeState:
    """Decode state whose attention caches are paged pools (per-slot
    positions: the serving engine is its only user); a hybrid's SSM
    states stay dense a slot (they are O(1) a slot). ``mesh``: a TPMesh
    to shard the pools over by kv head."""
    from repro_torch.kvcache.paged import init_paged_kv
    require_known_family(cfg)
    if cfg.family == "ssm":
        raise ValueError(f"family {cfg.family!r} holds no KV cache to page")
    dev = resolve_device(device)
    return DecodeState(pos=torch.zeros((batch,), dtype=torch.int32, device=dev),
                       paged=init_paged_kv(cfg, pcfg, batch, ranges, device=dev,
                                           mesh=mesh),
                       **_ssm_states(cfg, batch, dev))


def _layer(state: MambaState, *idx) -> MambaState:
    """The in-place view of one layer's states."""
    return MambaState(state.h[idx], state.conv[idx])


def _hybrid_sweep(params, state: DecodeState, x, cfg: ModelConfig, ctx,
                  attn_for_group):
    """The hybrid stack shared by the dense- and paged-cache routes:
    ``attn_for_group(g, x) -> x`` runs group g's application of the shared
    block against its own cache; the Mamba2 blocks and the remainder
    layers live here, in one place."""
    n_groups, rem = divmod(cfg.num_layers, cfg.attn_period)
    for g in range(n_groups):
        x = attn_for_group(g, x)
        for i in range(cfg.attn_period):
            with ctx.scope(f"groups/{g}/{i}"):
                x, _ = _mamba_block_decode(x, params["groups"][str(g)][str(i)],
                                           cfg, ctx, _layer(state.ssm, g, i))
    for i in range(rem):
        with ctx.scope(f"rest/{i}"):
            x, _ = _mamba_block_decode(x, params["rest"][str(i)], cfg, ctx,
                                       _layer(state.rest, i))
    return x


def decode_step(params, state: DecodeState, tokens: Optional[torch.Tensor],
                cfg: ModelConfig, ctx: Optional[Context] = None,
                embed: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, DecodeState]:
    """Decode tokens (B, T) (audio: (B, T, CB)) -> logits (B, T, V)
    (audio: (B, T, CB, V)). ``ctx`` hooks weight access (e.g.
    ``DequantContext`` for packed serving). ``embed`` (B, T, D), on the
    dense and the paged route alike, takes the place of the token
    embedding (``tokens`` may then be None): the vlm prefill's image
    patches.

    T > 1 (the speculative verify and the draft's catch-up) is bitwise T
    sequential one-token steps, logits and cache: every K/V row is
    written, then each query column reads under its own mask; the ops
    whose bits may depend on the row count (a library GEMM, rmsnorm's
    mean, MoE routing and capacity) run one call a column at the
    one-token shape (``ColumnContext``), and only the row-exact integer
    kernels see all B·T rows in one call. The ssm and hybrid families
    carry recurrent state, which a rejected draft could not rewind: they
    refuse T > 1, as the reference does."""
    require_known_family(cfg)
    ctx = ctx or Context()
    x = (embed if embed is not None else embed_tokens(params, tokens, cfg)
         ).to(cfg.param_dtype)
    tq = x.shape[1]
    if tq != 1 and cfg.family in ("ssm", "hybrid"):
        raise ValueError(
            f"multi-token decode needs a rollback-able cache; family "
            f"{cfg.family!r} carries recurrent state (T={tq})")
    if tq > 1:
        ctx = ColumnContext(ctx)
    pos = state.pos
    ps = state.paged
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            with ctx.scope(f"layers/{i}"):
                x, _ = _mamba_block_decode(x, params["layers"][str(i)], cfg,
                                           ctx, _layer(state.ssm, i))
    elif cfg.family == "hybrid":
        shared = params["shared"]

        def attn_for_group(g, h):
            # the decode scopes the shared block once, as "shared": its
            # weights are one leaf whatever the group
            with ctx.scope("shared"):
                if ps is not None:
                    h, _ = _attn_mlp_block_decode_paged(
                        h, shared, cfg, ctx, ps.layers[str(g)], ps.table, pos,
                        ps.write_limit)
                else:
                    h, _ = _attn_mlp_block_decode(
                        h, shared, cfg, ctx,
                        KVCache(state.kv.k[g], state.kv.v[g]), pos)
            return h

        x = _hybrid_sweep(params, state, x, cfg, ctx, attn_for_group)
    elif ps is not None:
        for i in range(cfg.num_layers):
            with ctx.scope(f"layers/{i}"):
                x, _ = _attn_mlp_block_decode_paged(
                    x, params["layers"][str(i)], cfg, ctx, ps.layers[str(i)],
                    ps.table, pos, ps.write_limit)
    else:
        for i in range(cfg.num_layers):
            ci = KVCache(state.kv.k[i], state.kv.v[i])
            with ctx.scope(f"layers/{i}"):
                x, _ = _attn_mlp_block_decode(x, params["layers"][str(i)],
                                              cfg, ctx, ci, pos)
    new_state = state._replace(pos=pos + tq)
    if tq == 1:
        return logits_from_hidden(params, x, cfg, ctx), new_state
    x = column_rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return split_codebooks(ctx.matmul("head", x, params["head"]), cfg), new_state


def prefill_into(params, state: DecodeState, tokens: torch.Tensor,
                 cfg: ModelConfig, ctx: Optional[Context] = None
                 ) -> Tuple[torch.Tensor, DecodeState]:
    """Continue a decode state over a span of tokens (B, C) (audio:
    (B, C, CB)): a loop of one-token ``decode_step`` calls — exact decode
    numerics. Returns the per-position logits (B, C, V) (audio: (B, C,
    CB, V)) and the advanced state."""
    out = []
    for c in range(tokens.shape[1]):
        logits, state = decode_step(params, state, tokens[:, c:c + 1], cfg,
                                    ctx=ctx)
        out.append(logits[:, 0])
    return torch.stack(out, dim=1), state


def prefill(params, inputs: Mapping[str, torch.Tensor], cfg: ModelConfig,
            max_len: int, ctx: Optional[Context] = None
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Run the whole prompt ``inputs["tokens"]`` (B, S) (audio: (B, S,
    CB)) from an empty dense state of ``max_len`` positions on the
    tokens' device: the per-position logits and the filled state,
    through ``prefill_into`` (exact decode numerics). The vlm family
    first ingests ``inputs["image_embed"]`` (B, T_img, D) a position at a
    time; its logits are the image positions' followed by the text's."""
    tokens = inputs["tokens"]
    state = init_decode_state(cfg, tokens.shape[0], max_len,
                              device=tokens.device)
    img_logits = []
    if cfg.family == "vlm" and "image_embed" in inputs:
        img = inputs["image_embed"]
        for t in range(img.shape[1]):
            logits, state = decode_step(params, state, None, cfg, ctx=ctx,
                                        embed=img[:, t:t + 1])
            img_logits.append(logits)
    logits, state = prefill_into(params, state, tokens, cfg, ctx=ctx)
    return torch.cat(img_logits + [logits], dim=1), state


def insert_ssm_slot(cfg: ModelConfig, state: DecodeState, sub: DecodeState,
                    slot: int) -> None:
    """Overwrite slot ``slot``'s whole SSM state (h and conv tail, every
    layer) with the batch-1 state ``sub``'s, in place: the batch axis is
    2 for the hybrid's (group, period) stack, 1 for the ssm stack and the
    hybrid's remainder."""
    if state.ssm is not None:
        ax = 2 if cfg.family == "hybrid" else 1
        for dst, src in zip(state.ssm, sub.ssm):
            dst.select(ax, slot).copy_(src.select(ax, 0))
    if state.rest is not None:
        for dst, src in zip(state.rest, sub.rest):
            dst.select(1, slot).copy_(src.select(1, 0))


def state_insert_slot(cfg: ModelConfig, state: DecodeState,
                      sub: DecodeState, slot: int) -> DecodeState:
    """Write a batch-1 dense state ``sub`` into row ``slot`` of a batched
    dense state (in place): its position, its KV rows and its SSM
    states."""
    state.pos[slot] = sub.pos.reshape(())
    if state.kv is not None:
        state.kv.k[:, slot] = sub.kv.k[:, 0]
        state.kv.v[:, slot] = sub.kv.v[:, 0]
    insert_ssm_slot(cfg, state, sub, slot)
    return state
