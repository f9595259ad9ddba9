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


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], even last dim -> uint8 nibbles, 2 per byte:
    an alias of ``qtensor.pack(q, 4, axis=-1)``. Packing runs along the
    last axis (head_dim for KV pages), so one token's (KV, Dh) row owns
    whole bytes."""
    from repro_torch import qtensor
    return qtensor.pack(q, 4, axis=-1)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """uint8 nibble pairs -> int8 (..., 2*D) (inverse of ``pack_int4``)."""
    from repro_torch import qtensor
    return qtensor.unpack(p, 4, axis=-1)


def int8_dots(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact full-K integer dots (M, N) int32 of (M, K) int8 x (K, N)
    int8: int32 on the CPU, float64 on CUDA (exact, as in
    ``qmm_group_dots``; ``require_full_k_safe`` keeps them in int32)."""
    # CUDA has no int32 matmul; integer dots below 2^31 are exact in fp64
    # rpr-ok: RPR003 the plain version's exact integer dots on CUDA
    dt = torch.int32 if x_q.device.type == "cpu" else torch.float64
    return (x_q.to(dt) @ w_q.to(dt)).to(torch.int32)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale, w_scale,
                out_dtype=torch.float32) -> torch.Tensor:
    """W8A8 matmul: int8 x (M, K) @ int8 w (K, N), int32 accumulate, then
    ``(f32(acc) * x_scale) * w_scale`` in that order (the reference's
    epilogue). x_scale: scalar or (M, 1); w_scale: scalar, (N,) or (1, N)."""
    acc = int8_dots(x_q, w_q).to(torch.float32)
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=acc.device)
    ws = torch.as_tensor(w_scale, dtype=torch.float32, device=acc.device)
    return (acc * xs * ws).to(out_dtype)


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
    # CUDA has no int32 matmul; integer dots below 2^31 are exact in fp64
    # rpr-ok: RPR003 the plain version's exact integer dots on CUDA
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


def fold_group_terms(terms: torch.Tensor, x_scale) -> torch.Tensor:
    """(G, M, N) fp32 group terms -> (M, N): the left fold over groups
    0..G-1, then one multiply by the per-row scales x_scale ((M, 1) or
    a scalar) — the ``qmm`` kernel's arithmetic on its own terms."""
    y = fold_groups(terms, 0)
    return y * torch.as_tensor(x_scale, dtype=torch.float32, device=y.device)


def qmm(x_q: torch.Tensor, w, x_scale, out_dtype=torch.float32) -> torch.Tensor:
    """Grouped-scale quantized matmul W{8,6,4,3}A8: the group products
    folded over the group axis, times the per-row activation scales."""
    return fold_group_terms(qmm_group_products(x_q, w), x_scale).to(out_dtype)


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
    # CUDA has no int32 matmul; integer dots below 2^31 are exact in fp64
    # rpr-ok: RPR003 the plain version's exact integer dots on CUDA
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

    At float precision this equals the reference's dense read path on
    the gathered values (the same einsums and mask); the port's dense
    ``attention_decode`` reads its cache through this function.
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
    qg = q.reshape(b, kvh, q.shape[2] // kvh, dh)
    sc = torch.einsum("bkgd,btkd->bkgt", qg.to(torch.float32),
                      kg.to(torch.float32)) * (dh ** -0.5)
    mask = torch.arange(t, device=kg.device)[None, None, None, :] \
        <= pos.reshape(b, 1, 1, 1)
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    pr = torch.softmax(sc, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", pr.to(vg.dtype), vg)


def fake_quant(x: torch.Tensor, scale, zero_point, bits: int,
               levels=None) -> torch.Tensor:
    """Quantize–dequantize on a uniform grid, in fp32, cast back to x's
    dtype: ``q = clip(round(x * (1/scale) + zp), 0, levels)``, then
    ``(q - zp) * scale``. ``scale``/``zero_point`` are scalars or
    broadcast against x (per-channel along any axis). ``levels`` is the
    largest grid index: default the affine 2^bits − 1; pass
    ``QuantSpec.levels`` (2^bits − 2) for symmetric specs. The reciprocal
    is multiplied (not divided), and the multiply and add round
    separately: the CUDA kernel does the same, bit for bit."""
    if levels is None:
        levels = 2.0 ** bits - 1.0
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    zp = torch.as_tensor(zero_point, dtype=torch.float32, device=x.device)
    inv = 1.0 / s
    # rpr-ok: RPR004 levels is a python number (a grid size), not a tensor
    lv = float(levels)
    q = torch.clamp(torch.round(x.to(torch.float32) * inv + zp), 0.0, lv)
    return ((q - zp) * s).to(x.dtype)


def clip_stats(x: torch.Tensor, scale, zero_point, bits: int, levels=None):
    """(clipped, total) fp32 element counts of one fake-quant call: how
    many grid indices ``round(x / scale + zp)`` fell outside [0, levels]
    and were clamped (the reference divides here, unlike its kernels)."""
    # rpr-ok: RPR004 levels is a python number (a grid size), not a tensor
    lv = (2.0 ** bits - 1.0) if levels is None else float(levels)
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    zp = torch.as_tensor(zero_point, dtype=torch.float32, device=x.device)
    q = torch.round(x.to(torch.float32) / s + zp)
    clipped = torch.sum(((q < 0.0) | (q > lv)).to(torch.float32))
    # rpr-ok: RPR004 numel() is a python int
    return clipped, torch.tensor(float(x.numel()), dtype=torch.float32,
                                 device=x.device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale=None) -> torch.Tensor:
    """Plain attention. q: (B, H, S, D); k, v: (B, H, T, D) -> (B, H, S, D)
    in q's dtype: fp32 scores times ``1/sqrt(D)``, the causal mask aligned
    bottom-right (query i sees keys j <= i + T − S; the caller refuses
    S > T, where a row would see nothing), an fp32 softmax, and P cast to
    v's dtype before P·V."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        s, t = q.shape[2], k.shape[2]
        mask = torch.tril(torch.ones((s, t), dtype=torch.bool,
                                     device=q.device), diagonal=t - s)
        logits = torch.where(mask, logits,
                             torch.full_like(logits, float("-inf")))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype), v).to(q.dtype)
