"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

The CPU route of every kernel wrapper, and what ``chip_smoke.py`` holds
each CUDA kernel against on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def ef_sqnorm(g: torch.Tensor) -> torch.Tensor:
    """Per-row squared L2 norm: g (B, N) -> (B,) float32 — the inner sum
    of the Empirical Fisher trace, Tr(Î) = (1/N) Σ_i ||∇f(z_i)||²."""
    g32 = g.to(torch.float32)
    return torch.sum(g32 * g32, dim=-1)


def qmm_group_dots(x_q: torch.Tensor, w) -> torch.Tensor:
    """Exact per-group integer dots (G, M, N) of (M, K) int8 x QTensor(K, N).

    ``int8 @ int8`` wraps in torch, so the CPU forms the dots in int32;
    CUDA has no int32 matmul, so there they are formed in float64, which
    holds them exactly (|dot| <= 127 * 127 * K < 2^53). Returned as
    int64 either way."""
    k, n = w.shape
    wi = w.unpack()                                   # (K, N) int8
    g = w.scale.shape[w.axis]
    gs = k // g
    dt = torch.int32 if x_q.device.type == "cpu" else torch.float64
    xg = x_q.to(dt).reshape(x_q.shape[0], g, gs).transpose(0, 1)  # (G, M, gs)
    wg = wi.to(dt).reshape(g, gs, n)
    return torch.bmm(xg, wg).to(torch.int64)


def qmm_group_products(x_q: torch.Tensor, w) -> torch.Tensor:
    """(G, M, N) fp32 per-group scaled partial products, no group sum:
    group g's slice is ``f32(int32 dot) * w_scale[g]``."""
    k, n = w.shape
    g = w.scale.shape[w.axis]
    ws = w.scale.reshape(g, n)
    return qmm_group_dots(x_q, w).to(torch.float32) * ws[:, None, :]


def fold_groups(terms: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over the group axis ``dim`` as a left fold in group order
    0..G-1 — the order of the CUDA kernels' fold, and one that does not
    depend on the layout around the axis."""
    parts = terms.unbind(dim)
    acc = parts[0]
    for t in parts[1:]:
        acc = acc + t
    return acc


def qmm(x_q: torch.Tensor, w, x_scale, out_dtype=torch.float32) -> torch.Tensor:
    """Grouped-scale quantized matmul W{8,6,4,3}A8: the group products
    folded over the group axis, times the per-row activation scales."""
    y = fold_groups(qmm_group_products(x_q, w), 0)
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=y.device)
    return (y * xs).to(out_dtype)


def _expert_ids(x_q: torch.Tensor, expert_ids) -> torch.Tensor:
    if expert_ids is None:
        return torch.arange(x_q.shape[0], device=x_q.device)
    return expert_ids.to(device=x_q.device, dtype=torch.int64)


def grouped_qmm_group_dots(x_q: torch.Tensor, w,
                           expert_ids=None) -> torch.Tensor:
    """Exact per-group integer dots (S, G, C, N) of (S, C, K) int8
    segments against their experts of a (E, K, N) QTensor stack, every
    row (past ``counts`` too); int64, formed as in ``qmm_group_dots``."""
    _, k, n = w.shape
    s, c = x_q.shape[0], x_q.shape[1]
    g = w.scale.shape[w.axis]
    gs = k // g
    wsel = w.unpack()[_expert_ids(x_q, expert_ids)]   # (S, K, N) int8
    dt = torch.int32 if x_q.device.type == "cpu" else torch.float64
    xg = x_q.to(dt).reshape(s, c, g, gs).transpose(1, 2).reshape(s * g, c, gs)
    wg = wsel.to(dt).reshape(s * g, gs, n)
    return torch.bmm(xg, wg).reshape(s, g, c, n).to(torch.int64)


def grouped_qmm(x_q: torch.Tensor, w, x_scale: torch.Tensor,
                counts: torch.Tensor, expert_ids=None,
                out_dtype=torch.float32) -> torch.Tensor:
    """Grouped ragged quantized matmul: every MoE expert's projection in
    one call. x_q: (S, C, K) int8 segments; ``w``: a ``quantize_experts``
    stack, logical (E, K, N) with per-expert scales (E, G, N); x_scale: (S, C, 1)
    fp32; counts: (S,) valid rows per segment; expert_ids: (S,) expert
    of each segment (default ``arange(S)``). Rows >= counts[s] are
    exactly 0.0, and segment s's valid rows equal
    ``qmm(x_q[s], expert_slice(w, ids[s]), x_scale[s])`` bit for bit
    (same int32 dots, same scale products, same group fold)."""
    s, c = x_q.shape[0], x_q.shape[1]
    ids = _expert_ids(x_q, expert_ids)
    wssel = w.scale[ids]                                    # (S, G, N)
    terms = (grouped_qmm_group_dots(x_q, w, ids).to(torch.float32)
             * wssel[:, :, None, :])                        # (S, G, C, N)
    y = fold_groups(terms, 1)
    y = y * torch.as_tensor(x_scale, dtype=torch.float32, device=y.device)
    rows = torch.arange(c, device=y.device)[None, :, None]
    cnt = counts.to(device=y.device)[:, None, None]
    return torch.where(rows < cnt, y, torch.zeros_like(y)).to(out_dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    pos: torch.Tensor, k_scale=None, v_scale=None,
                    bits: int = 16) -> torch.Tensor:
    """Decode-time GQA over a paged KV pool.

    q: (B, 1, H, Dh); k_pages/v_pages: (P, page, KV, Dh') fp, int8 or
    packed uint8; table: (B, NP) page ids (entries >= P are padding);
    pos: (B,) positions (positions <= pos attend); k_scale/v_scale:
    (P, KV) per-page per-kv-head scales. Returns (B, KV, G, Dh).

    At float precision this is bit-identical to the dense
    ``attention_decode`` read path (same gathered values, same einsums).
    """
    from repro_torch.qtensor import unpack

    b = q.shape[0]
    num_pages, page = k_pages.shape[0], k_pages.shape[1]
    kvh = k_pages.shape[2]
    ids = torch.clamp(table.long(), 0, num_pages - 1)
    kg = k_pages[ids]                      # (B, NP, page, KV, Dh')
    vg = v_pages[ids]
    if bits < 16:
        kg, vg = unpack(kg, bits), unpack(vg, bits)
        ks = k_scale[ids][:, :, None, :, None]
        vs = v_scale[ids][:, :, None, :, None]
        kg = kg.to(torch.float32) * ks
        vg = vg.to(torch.float32) * vs
    dh = kg.shape[-1]
    t = table.shape[1] * page
    kg = kg.reshape(b, t, kvh, dh)
    vg = vg.reshape(b, t, kvh, dh)
    g = q.shape[2] // kvh
    qg = q.reshape(b, kvh, g, dh)
    return decode_read(qg, kg, vg, pos.reshape(b, 1))


def decode_read(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                posb: torch.Tensor) -> torch.Tensor:
    """Masked one-pass softmax attention shared by the dense and paged
    read paths. qg: (B, KV, Gq, Dh); k/v: (B, T, KV, Dh); posb: (B, Gq')
    with Gq a multiple of Gq' (each query row attends positions <= its
    own). Returns (B, KV, Gq, Dh) in v's dtype."""
    b, kvh, gq, dh = qg.shape
    t = k.shape[1]
    sc = torch.einsum("bkgd,btkd->bkgt", qg.to(torch.float32),
                      k.to(torch.float32)) * (dh ** -0.5)
    rep = gq // posb.shape[1]
    pq = torch.repeat_interleave(posb, rep, dim=1)          # (B, Gq)
    mask = torch.arange(t, device=k.device)[None, None, None, :] \
        <= pq[:, None, :, None]
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    pr = torch.softmax(sc, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", pr.to(v.dtype), v)
