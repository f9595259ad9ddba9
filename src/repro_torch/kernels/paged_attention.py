"""Paged-attention decode with in-kernel dequant.

Replaces the TPU kernel
``src/repro/kernels/paged_attention.py:paged_attention_pallas`` with the
CUDA kernels of ``csrc/paged_attention.cu``. Bound by bytes on the card:
each valid page is read once and feeds 4·G flops per element. Pass 1
runs one block per (slot, kv-head, page): it unpacks the page in shared
memory with its (page, head) scale, scores the G query rows in fp32 and
writes the page's softmax partials; pass 2 folds the partials in page
order. Pages past a slot's length are skipped (they would add exactly
zero under the mask).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.qtensor import packed_size

MAX_SMEM = 227 * 1024          # dynamic shared memory one block may use
launches = 0
_KVMODE = {torch.float32: 32, torch.bfloat16: 16}


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    lengths: torch.Tensor, k_scale=None, v_scale=None,
                    bits: int = 16) -> torch.Tensor:
    """q: (B, KV, G, Dh) bf16/fp32; k_pages/v_pages: (P, page, KV, Dh')
    with Dh' = packed_size(Dh, bits); table: (B, NP) page ids (>= P are
    clipped, then masked); lengths: (B,) valid token counts; k_scale /
    v_scale: (P, KV) fp32 when bits < 16. Returns (B, KV, G, Dh) in q's
    dtype. A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    b, kvh, g, dh = q.shape
    if q.device.type == "cpu":
        o = ref.paged_attention(q.reshape(b, 1, kvh * g, dh), k_pages, v_pages,
                                table, lengths - 1, k_scale, v_scale, bits)
        return o.to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    num_pages, page, kvp, dhp = k_pages.shape
    if kvp != kvh or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention: pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_attention: q dtype {q.dtype}")
    if bits >= 16:
        kvmode = _KVMODE.get(k_pages.dtype)
        if kvmode is None or dhp != dh:
            raise ValueError(f"paged_attention: fp pages {k_pages.dtype} "
                             f"with Dh' {dhp} for Dh {dh}")
    else:
        kvmode = 8 if bits not in (6, 4, 3) else (6 if bits == 6 else 4)
        want = torch.int8 if kvmode == 8 else torch.uint8
        if k_pages.dtype != want or dhp != packed_size(dh, bits):
            raise ValueError(f"paged_attention: {bits}-bit pages must be "
                             f"{want} with Dh'={packed_size(dh, bits)}")
        if k_scale is None or v_scale is None or \
                tuple(k_scale.shape) != (num_pages, kvh):
            raise ValueError("paged_attention: quantized pages need (P, KV) "
                             "k_scale and v_scale")
    if 4 * (g * dh + 2 * page * dh + g * page) > MAX_SMEM:
        raise ValueError(f"paged_attention: page {page} x Dh {dh} does not "
                         "fit in one block's shared memory")
    table = table.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    if bits < 16:
        ks = k_scale.to(torch.float32).contiguous()
        vs = v_scale.to(torch.float32).contiguous()
    else:
        ks = vs = torch.ones((num_pages, kvh), dtype=torch.float32,
                             device=q.device)
    np_ = table.shape[1]
    out = torch.empty_like(q)
    # per-page softmax partials: max and denominator, then the accumulator
    part = torch.empty((2 + dh) * b * kvh * np_ * g, dtype=torch.float32,
                       device=q.device)
    if not (b and np_):
        return out.zero_()
    _launch(q, k_pages, v_pages, kvmode, table, lengths, ks, vs, out, part,
            b, kvh, g, dh, dhp, page, num_pages, np_)
    return out


def _launch(q, kp, vp, kvmode, table, lengths, ks, vs, out, part,
            b, kvh, g, dh, dhp, page, num_pages, np_) -> None:
    global launches
    from repro_torch.kernels import _build

    n = b * kvh * np_ * g
    ptr = part.data_ptr()
    err = _build.lib().paged_attention_launch(
        q.data_ptr(), 1 if q.dtype == torch.bfloat16 else 0, kp.data_ptr(),
        vp.data_ptr(), kvmode, table.data_ptr(), lengths.data_ptr(),
        ks.data_ptr(), vs.data_ptr(), out.data_ptr(), ptr, ptr + 4 * n,
        ptr + 8 * n, b, kvh, g, dh, dhp, page, num_pages, np_,
        _build.stream_ptr(q.device))
    _build.check(err, "paged_attention")
    launches += 1
