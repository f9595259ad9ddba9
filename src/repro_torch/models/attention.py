"""GQA attention with RoPE (port of ``repro.models.attention``): chunked
online-softmax for the full forward, and one-token decode against a
dense or paged KV cache.

Decode caches are updated IN PLACE (the reference returns new arrays):
a dense cache row or a page is written where it lives, which saves a
copy of the whole cache per step.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import apply_rope, init_dense
from repro_torch.obs import runtime as obs_rt


def init_attention(gen, cfg: ModelConfig, dtype) -> Dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": init_dense(gen, d, h * hd, dtype),
        "wk": init_dense(gen, d, kv * hd, dtype),
        "wv": init_dense(gen, d, kv * hd, dtype),
        "wo": init_dense(gen, h * hd, d, dtype),
    }


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks, never materializing the
    S×T scores. q: (B,S,H,Dh); k,v: (B,T,H,Dh) -> (B,S,H,Dh).

    The running max is a constant shift the output does not depend on,
    so it is taken from the detached scores: the forward's values are
    the reference's, the gradient the same function's, and the backward
    keeps no copy of a chunk's masked scores (one (B, H, S, chunk) fp32
    tensor less a layer where a gradient is taken)."""
    b, s, h, dh = q.shape
    t = k.shape[1]
    chunk = min(chunk, t)
    nk = -(-t // chunk)
    pad = nk * chunk - t
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qs = (q * (dh ** -0.5)).to(q.dtype)
    dev = q.device
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, s, h, dh), dtype=torch.float32, device=dev)
    qpos = torch.arange(s, device=dev)
    for idx in range(nk):
        ks = k[:, idx * chunk:(idx + 1) * chunk]
        vs = v[:, idx * chunk:(idx + 1) * chunk]
        sc = torch.einsum("bshd,bthd->bhst", qs.to(torch.float32),
                          ks.to(torch.float32))
        kpos = idx * chunk + torch.arange(chunk, device=dev)
        valid = (kpos[None, :] < t)
        if causal:
            valid = valid & (qpos[:, None] >= kpos[None, :])
        sc = torch.where(valid[None, None], sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, torch.amax(sc.detach(), dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        pv = torch.einsum("bhst,bthd->bshd", p.to(vs.dtype).to(torch.float32),
                          vs.to(torch.float32))
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def attention_apply(x: torch.Tensor, p: Dict, cfg: ModelConfig, ctx,
                    positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full causal attention for the forward pass. x: (B, S, D)."""
    b, s, d = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q = ctx.matmul("wq", x, p["wq"]).reshape(b, s, h, hd)
    k = ctx.matmul("wk", x, p["wk"]).reshape(b, s, kv, hd)
    v = ctx.matmul("wv", x, p["wv"]).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = ctx.tap("q", q)
    k = ctx.tap("k", k)
    v = ctx.tap("v", v)
    if kv != h:
        k = torch.repeat_interleave(k, h // kv, dim=2)
        v = torch.repeat_interleave(v, h // kv, dim=2)
    o = chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    o = ctx.tap("attn_out", o.reshape(b, s, h * hd))
    return ctx.matmul("wo", o, p["wo"])


class KVCache(NamedTuple):
    k: torch.Tensor        # (..., B, T, KV, Dh)
    v: torch.Tensor


def _qkv_decode(x, p, cfg, ctx, posb):
    b, tq = x.shape[0], x.shape[1]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = ctx.matmul("wq", x, p["wq"]).reshape(b, tq, h, hd)
    knew = ctx.matmul("wk", x, p["wk"]).reshape(b, tq, kv, hd)
    vnew = ctx.matmul("wv", x, p["wv"]).reshape(b, tq, kv, hd)
    q = apply_rope(q, posb, cfg.rope_theta)
    knew = apply_rope(knew, posb, cfg.rope_theta)
    return q, knew, vnew


def _write_dense(pairs, rows: torch.Tensor, posb: torch.Tensor) -> None:
    """c[rows, posb] = new in place for each (c, new) of ``pairs``, with
    writes at positions >= T dropped as the reference's scatter drops them
    (a slot riding a decode burst past its last position), and no host
    sync: a dropped write lands on T-1 carrying the value T-1 ends with
    anyway — the in-range write to T-1 of the same call, or else the
    value already there."""
    t, tq = pairs[0][0].shape[1], posb.shape[1]
    valid = (posb < t)[..., None, None]
    wpos = torch.clamp(posb, max=t - 1)
    ar = rows[:, 0]
    if tq > 1:
        jlast = torch.clamp(t - 1 - posb[:, 0], 0, tq - 1)
        hit = ((posb[:, 0] <= t - 1) & (posb[:, -1] >= t - 1))[:, None, None, None]
    for c, new in pairs:
        new = new.to(c.dtype)
        if tq == 1:
            last = c[rows, wpos]
        else:
            last = torch.where(hit, new[ar, jlast][:, None], c[ar, t - 1][:, None])
        c[rows, wpos] = torch.where(valid, new, last)


# the static symmetric scale of an int8 dense cache (the reference's
# attention_decode grid; the speculative draft lane's KV storage)
KV_SCALE = 0.05


def quantize_dense_kv_values(x: torch.Tensor) -> torch.Tensor:
    """Float K/V -> an int8 dense cache's values: ``clip(round(x /
    KV_SCALE), ±127)``."""
    return torch.clamp(torch.round(x.to(torch.float32) / KV_SCALE),
                       -127, 127).to(torch.int8)


def attention_decode(x: torch.Tensor, p: Dict, cfg: ModelConfig, ctx,
                     cache: KVCache, pos: torch.Tensor
                     ) -> Tuple[torch.Tensor, KVCache]:
    """Decode x: (B, T, D) at consecutive positions against a dense cache
    (B, T_max, KV, Dh) in the model dtype, or in int8 on the static
    ``KV_SCALE`` grid. ``pos`` is a () scalar or a (B,) per-slot vector;
    row b's tokens land at pos[b] .. pos[b]+T-1.

    The read goes through ``ops.paged_attention`` with the cache viewed
    as pages of ``dense_page_size(T_max)`` tokens and an identity page
    table: on the card a dense cache and a paged pool of 16-token pages
    holding the same values read through one kernel, bit for bit; on
    the CPU the plain version equals the reference's dense read. An int8
    cache reads as 8-bit pages whose every scale is ``KV_SCALE``."""
    b, tq = x.shape[0], x.shape[1]
    offs = torch.arange(tq, dtype=torch.int64, device=x.device)
    posb = (pos.reshape(-1, 1).to(torch.int64) + offs[None, :]).expand(b, tq)
    q, knew, vnew = _qkv_decode(x, p, cfg, ctx, posb)
    quant = cache.k.dtype == torch.int8
    if quant:
        knew, vnew = quantize_dense_kv_values(knew), quantize_dense_kv_values(vnew)
    if isinstance(cache.k, ShardedKV):
        o = _sharded_update_read(q, knew, vnew, cache.k, cache.v, posb)
    else:
        rows = torch.arange(b, device=x.device)[:, None].expand(b, tq)
        _write_dense(((cache.k, knew), (cache.v, vnew)), rows, posb)
        o = _dense_read(q, cache.k, cache.v, posb)
    o = ctx.tap("attn_out", o.to(x.dtype))
    return ctx.matmul("wo", o, p["wo"]), cache


def _dense_read(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                posb: torch.Tensor) -> torch.Tensor:
    """Read a dense cache k, v (B, T_max, KV, Dh) — int8 on the
    ``KV_SCALE`` grid, or fp — as pages of ``dense_page_size(T_max)``
    tokens with an identity page table: (B, T, KV·G·Dh) in q's dtype."""
    b, t = k.shape[0], k.shape[1]
    page = dense_page_size(t)
    kp = k.reshape((b * t // page, page) + tuple(k.shape[2:]))
    vp = v.reshape(kp.shape)
    table = torch.arange(kp.shape[0], dtype=torch.int32,
                         device=q.device).reshape(b, t // page)
    sc, bits = None, 16
    if k.dtype == torch.int8:
        sc = torch.full((kp.shape[0], kp.shape[2]), KV_SCALE,
                        dtype=torch.float32, device=q.device)
        bits = 8
    # the reference's dense read is no paged-attention dispatch: its
    # counters stay silent here, as there
    with obs_rt.suspended():
        return _paged_read(q, kp, vp, table, posb, sc, sc, bits).to(q.dtype)


class ShardedKV:
    """K or V of a data row's dense cache in a mesh decode step
    (``launch.steps.build_decode_step``): ``parts[c]`` is model shard
    c's slice, laid out by ``launch.steps.decode_state_pspecs``:
    ``"heads"`` splits the kv heads, ``"seq"`` the positions, and
    ``"repl"`` gives every shard the whole cache. Indexing selects a
    layer of every part."""

    def __init__(self, mesh, row, lead, parts, mode: str):
        if mode not in ("heads", "seq", "repl"):
            raise ValueError(f"mode must be heads|seq|repl, got {mode!r}")
        self.mesh, self.row, self.lead = mesh, list(row), tuple(lead)
        self.parts, self.mode = dict(parts), mode

    def __getitem__(self, i) -> "ShardedKV":
        return ShardedKV(self.mesh, self.row, self.lead,
                         {c: p[i] for c, p in self.parts.items()}, self.mode)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[self.lead].dtype


def _sharded_update_read(q, knew, vnew, ck: ShardedKV, cv: ShardedKV,
                         posb: torch.Tensor) -> torch.Tensor:
    """Write the new K/V into a row's sharded cache and read it:
    (B, T, H·Dh) on the row's lead device.

      * heads — shard i writes its kv heads and reads its query heads
        through ``_dense_read`` (the paged kernel on the card); the head
        outputs are all-gathered in head order, the replicated read's;
      * seq — the shard holding a position writes it; each shard scores
        its positions and keeps the softmax partials (running max, sum,
        weighted V in fp32), combined across shards in shard order
        (``pmax`` of the maxima, then ``psum`` of the rescaled sums);
      * repl — every shard writes its copy; the lead's is read.
    """
    mesh, row, lead = ck.mesh, ck.row, ck.lead
    b, tq = posb.shape
    if ck.mode == "repl":
        for c in row:
            d = mesh.device(c)
            rows = torch.arange(b, device=d)[:, None].expand(b, tq)
            _write_dense(((ck.parts[c], knew.to(d)), (cv.parts[c], vnew.to(d))),
                         rows, posb.to(d))
        return _dense_read(q, ck.parts[lead], cv.parts[lead], posb)
    if ck.mode == "heads":
        kvl = knew.shape[2] // len(row)
        g = q.shape[2] // knew.shape[2]
        outs = {}
        for i, c in enumerate(row):
            d = mesh.device(c)
            hs = slice(i * kvl, (i + 1) * kvl)
            pd = posb.to(d)
            rows = torch.arange(b, device=d)[:, None].expand(b, tq)
            _write_dense(((ck.parts[c], knew[:, :, hs].to(d)),
                          (cv.parts[c], vnew[:, :, hs].to(d))), rows, pd)
            outs[c] = _dense_read(q[:, :, hs.start * g:hs.stop * g].to(d),
                                  ck.parts[c], cv.parts[c], pd)
        return mesh.all_gather(outs, "model", dim=-1)[lead]
    if tq != 1:
        raise NotImplementedError(
            "multi-token decode is not supported on a sequence-sharded cache")
    ms, ls, accs = {}, {}, {}
    kvh, dh = knew.shape[2], knew.shape[3]
    g = q.shape[2] // kvh
    for i, c in enumerate(row):
        d = mesh.device(c)
        kc, vc = ck.parts[c], cv.parts[c]
        tl = kc.shape[1]
        pd = posb[:, 0].to(d)
        local = pd - i * tl
        mine = ((local >= 0) & (local < tl))[:, None, None]
        at = torch.clamp(local, 0, tl - 1)
        ar = torch.arange(b, device=d)
        for cache, new in ((kc, knew), (vc, vnew)):
            cache[ar, at] = torch.where(mine, new[:, 0].to(d, cache.dtype),
                                        cache[ar, at])
        kf, vf = kc.to(torch.float32), vc.to(torch.float32)
        if kc.dtype == torch.int8:
            kf, vf = kf * KV_SCALE, vf * KV_SCALE
        qg = q[:, 0].to(d, torch.float32).reshape(b, kvh, g, dh)
        sc = torch.einsum("bkgd,btkd->bkgt", qg, kf) * (dh ** -0.5)
        valid = (i * tl + torch.arange(tl, device=d))[None, :] <= pd[:, None]
        sc = torch.where(valid[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
        m = torch.amax(sc, dim=-1)
        pr = torch.exp(sc - m[..., None])
        ms[c], ls[c] = m, torch.sum(pr, dim=-1)
        accs[c] = torch.einsum("bkgt,btkd->bkgd", pr, vf)
    m_all = mesh.pmax(ms, "model")
    scale = {c: torch.exp(ms[c] - m_all[c]) for c in row}
    # rpr-ok: RPR002 decode-path fp32 softmax partials of disjoint position ranges, folded in shard order (the mesh step is not under the serving engine's exactness contract)
    l_all = mesh.psum({c: ls[c] * scale[c] for c in row}, "model")[lead]
    # rpr-ok: RPR002 decode-path fp32 softmax partials of disjoint position ranges, folded in shard order
    acc = mesh.psum({c: accs[c] * scale[c][..., None] for c in row}, "model")[lead]
    o = acc / torch.clamp_min(l_all, 1e-30)[..., None]
    return o.reshape(b, 1, kvh * g * dh)


def _paged_read(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                table: torch.Tensor, posb: torch.Tensor, k_scale=None,
                v_scale=None, bits: int = 16) -> torch.Tensor:
    """q: (B, T, H, Dh) at positions posb (B, T) -> (B, T, H*Dh): one
    ``ops.paged_attention`` call per query column over the pages."""
    from repro_torch.kernels import ops as kops

    b, tq = posb.shape
    outs = [kops.paged_attention(q[:, j:j + 1], k, v, table, posb[:, j],
                                 k_scale, v_scale, bits) for j in range(tq)]
    o = outs[0] if tq == 1 else torch.stack(outs, dim=1)
    return o.reshape(b, tq, -1)


def dense_page_size(t: int) -> int:
    """Page size of a dense cache of ``t`` positions read as pages: 16
    (the paged engine's default) when it divides ``t``, else the largest
    divisor of ``t`` below 16."""
    return next(d for d in range(min(16, t), 0, -1) if t % d == 0)


def attention_decode_paged(x: torch.Tensor, p: Dict, cfg: ModelConfig, ctx,
                           lp, table: torch.Tensor, pos: torch.Tensor,
                           write_limit: torch.Tensor):
    """One-token decode against a paged KV pool (``kvcache.LayerPages``,
    or a kv-head-sharded ``kvcache.ShardedPages``).

    The new token's K/V are quantized with the page's scale and written
    into the slot's current page; writes at positions >= ``write_limit``
    are dropped (``kvcache.paged.write_tokens``), so a stale slot never
    touches a recycled page. The read walks the page table through
    ``ops.paged_attention``.
    """
    from repro_torch.kvcache.paged import ShardedPages

    b, tq = x.shape[0], x.shape[1]
    posb = pos.reshape(-1, 1).to(torch.int64) \
        + torch.arange(tq, dtype=torch.int64, device=x.device)[None, :]
    q, knew, vnew = _qkv_decode(x, p, cfg, ctx, posb)

    page, num_pages = lp.page_size, lp.num_pages
    rows = torch.arange(b, device=x.device)[:, None].expand(b, tq)
    col = torch.clamp(posb // page, 0, table.shape[1] - 1)
    pid = torch.where(posb < write_limit.reshape(-1, 1).to(torch.int64),
                      table.to(torch.int64)[rows, col],
                      torch.full_like(posb, num_pages))
    off = posb % page
    sp = torch.clamp(pid, 0, num_pages - 1)
    if isinstance(lp, ShardedPages):
        # kv-head sharding (port of the reference's
        # ``_paged_update_attend_sharded``): shard i writes its own heads'
        # K/V (per-head elementwise: the values of the replicated path)
        # and decodes its grouped query heads over its pages alone; the
        # outputs concatenated along the head axis are the replicated
        # read, bit for bit
        if tq != 1:
            raise NotImplementedError(
                "multi-token paged decode is not supported under "
                "kv-head-sharded serving (mesh=...)")
        g = q.shape[2] // knew.shape[2]
        if obs_rt.emitting():
            # counted once from the REPLICATED positions (tp-invariant);
            # the per-shard reads below are suspended
            from repro_torch.kernels.paged_attention import read_token_stats
            obs_rt.emit("paged_calls", 1.0)
            obs_rt.emit("paged_tokens_read", read_token_stats(posb[:, 0]))
        outs = []
        for i, (sh, d) in enumerate(zip(lp.shards, lp.mesh.devices)):
            hs = lp.heads(i)
            with obs_rt.suspended():
                outs.append(_update_attend(
                    sh, q[:, :, hs.start * g:hs.stop * g].to(d),
                    knew[:, :, hs].to(d), vnew[:, :, hs].to(d), table.to(d),
                    posb.to(d), pid.to(d), off.to(d), sp.to(d)))
        o = lp.mesh.all_gather(outs, dim=2)
    else:
        o = _update_attend(lp, q, knew, vnew, table, posb, pid, off, sp)
    o = ctx.tap("attn_out", o.to(x.dtype))
    return ctx.matmul("wo", o, p["wo"]), lp


def _update_attend(lp, q, knew, vnew, table, posb, pid, off, sp):
    """Quantize the new K/V with their page's scale (or cast them to the
    pool's dtype), write them into the pool ``lp`` and read it with
    paged attention: (B, T, heads·Dh)."""
    from repro_torch.kvcache.paged import quantize_kv, write_tokens

    if lp.bits < 16:
        kq = quantize_kv(knew, lp.k_scale[sp], lp.bits)
        vq = quantize_kv(vnew, lp.v_scale[sp], lp.bits)
    else:
        kq, vq = knew.to(lp.k.dtype), vnew.to(lp.v.dtype)
    write_tokens(lp, pid, off, kq, vq)
    return _paged_read(q, lp.k, lp.v, table, posb, lp.k_scale, lp.v_scale,
                       lp.bits)
