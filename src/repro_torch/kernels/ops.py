"""Dispatch over the kernels (port of ``repro.kernels.ops``).

A CPU tensor takes the plain PyTorch version (``kernels.ref``); a CUDA
tensor launches the hand-written kernel, which raises if it cannot run.
There is no environment switch and no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ef_sqnorm import ef_sqnorm as _ef_sqnorm
from repro_torch.kernels.grouped_qmm import grouped_qmm as _grouped_qmm
from repro_torch.kernels.paged_attention import (
    paged_attention as _paged_attention)
from repro_torch.kernels.qmm import qmm as _qmm


def ef_sqnorm(g: torch.Tensor) -> torch.Tensor:
    """(B, N) per-sample gradients -> (B,) fp32 squared norms."""
    return _ef_sqnorm(g)


def qmm(x_q: torch.Tensor, w, x_scale, out_dtype=torch.float32) -> torch.Tensor:
    """(M, K) int8 x packed QTensor (K, N) with per-row fp32 scales; the
    kernel wrapper proves the int32 group dots cannot overflow."""
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=x_q.device)
    if xs.numel() == 1:
        xs = xs.reshape(1).expand(x_q.shape[0])
    return _qmm(x_q, w, xs.reshape(-1)).to(out_dtype)


def grouped_qmm(x_q: torch.Tensor, w, x_scale: torch.Tensor,
                counts: torch.Tensor, expert_ids=None,
                out_dtype=torch.float32) -> torch.Tensor:
    """(S, C, K) int8 capacity-sorted MoE segments x a packed
    ``quantize_experts`` stack (E, K, N) with (S, C, 1) fp32 row scales;
    counts: (S,) valid rows per segment, expert_ids: (S,) expert of each
    segment (default ``arange(S)``). Rows past a segment's count come
    back exactly 0.0; the counts stay on the device."""
    return _grouped_qmm(x_q, w, x_scale, counts, expert_ids).to(out_dtype)


def paged_attention(q, k_pages, v_pages, table, pos, k_scale=None,
                    v_scale=None, bits: int = 16) -> torch.Tensor:
    """Decode GQA over paged KV. q: (B, 1, H, Dh) -> (B, KV, G, Dh) in
    q's dtype. The wrapper takes ``pos + 1`` as lengths; its CPU route
    is the plain gather version, bit-identical to the dense read path."""
    kvh = k_pages.shape[2]
    b, _, h, dh = q.shape
    qh = q.reshape(b, kvh, h // kvh, dh)
    return _paged_attention(qh, k_pages, v_pages, table, pos + 1,
                            k_scale, v_scale, bits)
