"""Dispatch over the kernels (port of ``repro.kernels.ops``).

A CPU tensor takes the plain PyTorch version (``kernels.ref``); a CUDA
tensor launches the hand-written kernel, which raises if it cannot run.
There is no environment switch and no fallback.

Inside an obs counter region (``obs.runtime.collecting``) the serving
kernels emit their call counts (host numbers) and, on a sampled burst,
their clip statistics (device tensors), as the reference's dispatch
layer does; outside one, the check is all they pay.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.bounds import require_full_k_safe
from repro_torch.kernels.ef_sqnorm import ef_sqnorm as _ef_sqnorm
from repro_torch.kernels.fake_quant import clip_stats
from repro_torch.kernels.fake_quant import fake_quant as _fake_quant
from repro_torch.kernels.flash_attention import (
    flash_attention as _flash_attention)
from repro_torch.kernels.grouped_qmm import grouped_qmm as _grouped_qmm
from repro_torch.kernels.int8_matmul import activation_saturation
from repro_torch.kernels.int8_matmul import int8_matmul as _int8_matmul
from repro_torch.kernels.paged_attention import attend as _attend
from repro_torch.kernels.paged_attention import read_token_stats
from repro_torch.kernels.qmm import qmm as _qmm
from repro_torch.kernels.qmm import qmm_groups as _qmm_groups
from repro_torch.kernels.qmm import qmm_groups_fold as _qmm_groups_fold
from repro_torch.kernels.qmm import saturation_stats
from repro_torch.obs import runtime as obs_rt


def _emit_matmul(calls: str, x_q: torch.Tensor, stats) -> None:
    """One matmul dispatch's counters: its call, and on a sampled burst
    the saturation of its int8 activation."""
    obs_rt.emit(calls, 1.0)
    if obs_rt.emitting_stats():
        sat, total = stats(x_q)
        obs_rt.emit("act_sat", sat)
        obs_rt.emit("act_elems", total)


def fake_quant(x: torch.Tensor, scale, zero_point, bits: int,
               levels=None) -> torch.Tensor:
    """Quantize–dequantize x on the grid of (scale, zero_point): scalars
    run the per-tensor kernel, scales broadcast along one axis of x (any
    axis) the per-channel one. ``levels``: the largest grid index —
    default affine 2^bits − 1; pass ``QuantSpec.levels`` (2^bits − 2)
    for symmetric specs."""
    if obs_rt.emitting_stats():
        clipped, total = clip_stats(x, scale, zero_point, bits, levels)
        obs_rt.emit("fq_clip", clipped)
        obs_rt.emit("fq_elems", total)
    return _fake_quant(x, scale, zero_point, bits, levels=levels)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """(B, H, S, D) x (B, H, T, D) attention with the causal mask aligned
    bottom-right; causal S > T is refused."""
    return _flash_attention(q, k, v, causal=causal)


def ef_sqnorm(g: torch.Tensor) -> torch.Tensor:
    """(B, N) per-sample gradients -> (B,) fp32 squared norms."""
    return _ef_sqnorm(g)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale, w_scale,
                out_dtype=torch.float32) -> torch.Tensor:
    """W8A8: (M, K) int8 x (K, N) int8 with per-row activation scales
    (a scalar, (M,) or (M, 1) ``x_scale``) and per-channel weight scales.
    The full-K overflow proof runs on every route. The scales are
    normalised once, in the kernel wrapper; an fp32 ``out_dtype`` adds
    no cast."""
    require_full_k_safe(8, 8, x_q.shape[-1], where="ops.int8_matmul")
    if obs_rt.emitting():
        _emit_matmul("int8mm_calls", x_q, activation_saturation)
    y = _int8_matmul(x_q, w_q, x_scale, w_scale)
    return y if out_dtype == torch.float32 else y.to(out_dtype)


def qmm(x_q: torch.Tensor, w, x_scale, out_dtype=torch.float32) -> torch.Tensor:
    """(M, K) int8 x packed QTensor (K, N) with per-row fp32 scales; the
    kernel wrapper proves the int32 group dots cannot overflow."""
    if obs_rt.emitting():
        _emit_matmul("qmm_calls", x_q, saturation_stats)
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=x_q.device)
    if xs.numel() == 1:
        xs = xs.reshape(1).expand(x_q.shape[0])
    return _qmm(x_q, w, xs.reshape(-1)).to(out_dtype)


def qmm_group_products(x_q: torch.Tensor, w) -> torch.Tensor:
    """(M, K) int8 x packed QTensor (K, N) -> (G, M, N) fp32 per-group
    scaled terms, no group sum: the shard-local product of a K-sharded
    (row-parallel) block. The wrapper proves the group dots fit int32."""
    return _qmm_groups(x_q, w)


def fold_group_terms(terms: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """(G, M, N) fp32 terms (gathered from the shards) and (M,) fp32 row
    scales -> (M, N) fp32: folded over the groups in order and scaled
    per row, as ``qmm`` folds its own terms."""
    return _qmm_groups_fold(terms, x_scale)


def grouped_qmm(x_q: torch.Tensor, w, x_scale: torch.Tensor,
                counts: torch.Tensor, expert_ids=None,
                out_dtype=torch.float32) -> torch.Tensor:
    """(S, C, K) int8 capacity-sorted MoE segments x a packed
    ``quantize_experts`` stack (E, K, N) with (S, C, 1) fp32 row scales;
    counts: (S,) valid rows per segment, expert_ids: (S,) expert of each
    segment (default ``arange(S)``). Rows past a segment's count come
    back exactly 0.0; the counts stay on the device."""
    if obs_rt.emitting():
        _emit_matmul("qmm_calls", x_q, saturation_stats)
    return _grouped_qmm(x_q, w, x_scale, counts, expert_ids).to(out_dtype)


def paged_attention(q, k_pages, v_pages, table, pos, k_scale=None,
                    v_scale=None, bits: int = 16) -> torch.Tensor:
    """Decode GQA over paged KV. q: (B, 1, H, Dh) -> (B, KV, G, Dh) in
    q's dtype; ``pos`` (B,) int32/int64 positions (positions <= pos
    attend), read by the kernel with an offset of 1 (no ``pos + 1`` op).
    The CPU route is the plain gather version, bit-identical to the dense
    read path."""
    if obs_rt.emitting():
        obs_rt.emit("paged_calls", 1.0)
        obs_rt.emit("paged_tokens_read", read_token_stats(pos))
    kvh = k_pages.shape[2]
    b, _, h, dh = q.shape
    qh = q.reshape(b, kvh, h // kvh, dh)
    return _attend(qh, k_pages, v_pages, table, pos, 1, k_scale, v_scale,
                   bits)
