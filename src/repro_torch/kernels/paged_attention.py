"""Paged-attention decode with in-kernel dequant.

Replaces the TPU kernel
``src/repro/kernels/paged_attention.py:paged_attention_pallas`` with the
CUDA kernel of ``csrc/paged_attention.cu``, one launch a call. Bound by
bytes on the card: each valid page is read once and feeds 4·G flops per
element. A CTA takes a run of one (slot, kv-head)'s pages and its warps
own pages of that run: each warp loads its pages' K and V rows with
vector loads, dequantizes them in registers, scores the G query rows and
keeps a running fp32 softmax; the CTA folds its warps' partials in page
order, and where a context spans several CTAs the last one to finish
folds theirs in split order. ``launch_plan`` fixes that split from NP,
the page size, Dh, G and the KV width alone, so a slot served alone
equals the same slot in a batch, and a kv-head shard its heads of the
full call, bit for bit. Pages past a slot's length are skipped (they
would add exactly zero under the mask).

Around the launch the only device work is allocating the output (and,
where the plan splits a context, the partials' scratch): the kernel
reads the table and lengths as given (int32 or int64, strided) with an
offset added to the lengths, takes no scales for fp pages, and resets the
per-(slot, head) tickets it counts with.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.qtensor import packed_size

MAX_SMEM = 227 * 1024          # dynamic shared memory one block may use
MAX_WARPS = 8                  # warps a CTA (the kernel's launch bound: 256 threads)
MAX_SPLITS = 8                 # CTAs a (slot, head) before a warp takes more pages
MAX_PAGES_PER_WARP = 32        # a warp's page ids sit one a lane
VPC = 16                       # values of a lane's chunk of a row
MAX_GRID_Y = 65535
launches = 0
_KVMODE = {torch.float32: 32, torch.bfloat16: 16}


class PagedPlan(NamedTuple):
    pages_per_warp: int
    warps: int                 # warps a CTA
    ctas: int                  # CTAs a (slot, head): grid.y
    lanes_log2: int            # log2 of the lanes that hold one token row
    chunk_sets: int            # passes over a row's 16-value chunks (Dh > 512)
    dpad: int                  # a query row padded to whole lane chunks
    smem: int                  # dynamic shared memory a CTA, bytes


@lru_cache(maxsize=256)
def launch_plan(np_: int, page: int, dh: int, g: int, kvmode: int) -> PagedPlan:
    """The kernel's split of one (slot, kv-head)'s NP pages: a function of
    (NP, page, Dh, G, KV width) alone, never of B or the number of kv
    heads (the page size and the width change none of it today). A warp
    takes a page and a CTA up to 8 warps, so a context of up to 8 pages
    is one CTA; past 64 pages (8 CTAs) the warps take more pages. A lane
    holds 16 values of a row, a row ``2^lanes_log2`` lanes."""
    nc = -(-dh // VPC)
    lanes = min(32, 1 << max(0, nc - 1).bit_length())
    chunk_sets = -(-nc // lanes)
    dpad = chunk_sets * lanes * VPC
    np_ = max(1, np_)
    ppw = min(MAX_PAGES_PER_WARP, -(-np_ // (MAX_WARPS * MAX_SPLITS)))
    warps = min(MAX_WARPS, -(-np_ // ppw))

    def smem(w: int) -> int:
        return 4 * (g * dpad + w * g * dpad + 2 * w * g)

    while warps > 1 and smem(warps) > MAX_SMEM:
        warps -= 1
    ctas = -(-np_ // (warps * ppw))
    return PagedPlan(ppw, warps, ctas, lanes.bit_length() - 1, chunk_sets,
                     dpad, smem(warps))


def kv_mode(dtype: torch.dtype, bits: int):
    """The kernel's page format: 32/16 fp32/bf16 pages, 8 int8 (also 7-
    and 5-bit grids), 6 packed 6-bit, 4 nibbles (4- and 3-bit); None for
    fp pages of another dtype."""
    if bits >= 16:
        return _KVMODE.get(dtype)
    return {6: 6, 4: 4, 3: 4}.get(bits, 8)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    lengths: torch.Tensor, k_scale=None, v_scale=None,
                    bits: int = 16) -> torch.Tensor:
    """q: (B, KV, G, Dh) bf16/fp32; k_pages/v_pages: (P, page, KV, Dh')
    with Dh' = packed_size(Dh, bits); table: (B, NP) page ids (>= P are
    clipped, then masked); lengths: (B,) valid token counts; k_scale /
    v_scale: (P, KV) fp32 when bits < 16. Returns (B, KV, G, Dh) in q's
    dtype. A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    return attend(q, k_pages, v_pages, table, lengths, 0, k_scale, v_scale,
                  bits)


def attend(q, k_pages, v_pages, table, lengths, offset: int, k_scale=None,
           v_scale=None, bits: int = 16) -> torch.Tensor:
    """``paged_attention`` with valid token counts ``lengths + offset``
    (``ops.paged_attention`` passes positions with offset 1)."""
    b, kvh, g, dh = q.shape
    if q.device.type == "cpu":
        pos = lengths if offset == 1 else lengths + (offset - 1)
        o = ref.paged_attention(q.reshape(b, 1, kvh * g, dh), k_pages, v_pages,
                                table, pos, k_scale, v_scale, bits)
        return o.to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    num_pages, page, kvp, dhp = k_pages.shape
    if kvp != kvh or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention: pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_attention: q dtype {q.dtype}")
    kvmode = kv_mode(k_pages.dtype, bits)
    if bits >= 16:
        if kvmode is None or dhp != dh:
            raise ValueError(f"paged_attention: fp pages {k_pages.dtype} "
                             f"with Dh' {dhp} for Dh {dh}")
    else:
        want = torch.int8 if kvmode == 8 else torch.uint8
        if k_pages.dtype != want or dhp != packed_size(dh, bits):
            raise ValueError(f"paged_attention: {bits}-bit pages must be "
                             f"{want} with Dh'={packed_size(dh, bits)}")
        if k_scale is None or v_scale is None or \
                tuple(k_scale.shape) != (num_pages, kvh) or \
                tuple(v_scale.shape) != (num_pages, kvh):
            raise ValueError("paged_attention: quantized pages need (P, KV) "
                             "k_scale and v_scale")
    if table.ndim != 2 or table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"paged_attention: table {tuple(table.shape)} and "
                         f"lengths {tuple(lengths.shape)} for B={b}")
    for name, t in (("table", table), ("lengths", lengths)):
        if t.dtype not in (torch.int32, torch.int64) or t.device != q.device:
            raise ValueError(f"paged_attention: {name} must be int32 or int64 "
                             f"on {q.device}, not {t.dtype} on {t.device}")
    np_ = table.shape[1]
    plan = launch_plan(np_, page, dh, g, kvmode)
    if plan.smem > MAX_SMEM or plan.ctas > MAX_GRID_Y:
        raise ValueError(f"paged_attention: G={g} x Dh={dh} over {np_} pages "
                         "does not fit the kernel's launch")
    if q.stride()[1:] != (g * dh, dh, 1):
        q = q.contiguous()
    if table.stride(1) != 1:
        table = table.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    ks = vs = None
    if bits < 16:
        ks = k_scale.to(torch.float32).contiguous()
        vs = v_scale.to(torch.float32).contiguous()
    out = torch.empty((b, kvh, g, dh), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    part = tickets = None
    if plan.ctas > 1:
        from repro_torch.kernels import _build
        # room for every (slot, head, CTA): which slots span CTAs depends
        # on the lengths, which stay on the card
        part = torch.empty(b * kvh * plan.ctas * g * (2 + dh),
                           dtype=torch.float32, device=q.device)
        tickets = _build.ticket_buffer(q.device, b * kvh)
    _launch(q, k_pages, v_pages, kvmode, table, lengths, offset, ks, vs, out,
            part, tickets, plan, num_pages)
    return out


def _launch(q, kp, vp, kvmode, table, lengths, offset, ks, vs, out, part,
            tickets, plan: PagedPlan, num_pages) -> None:
    global launches
    from repro_torch.kernels import _build

    b, kvh, g, dh = q.shape
    page, dhp = kp.shape[1], kp.shape[3]
    grain = {6: 4, 4: 8}.get(kvmode, 16)      # bytes of the kernel's vector loads
    vec = (dh % VPC == 0 and kp.data_ptr() % grain == 0
           and vp.data_ptr() % grain == 0)
    err = _build.lib().paged_attention_launch(
        q.data_ptr(), 1 if q.dtype == torch.bfloat16 else 0, q.stride(0),
        kp.data_ptr(), vp.data_ptr(), kvmode, table.data_ptr(),
        table.element_size(), table.stride(0), lengths.data_ptr(),
        lengths.element_size(), lengths.stride(0), offset,
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), b, kvh, g, dh, dhp,
        page, num_pages, table.shape[1], plan.pages_per_warp, plan.warps,
        plan.ctas, plan.lanes_log2, plan.chunk_sets, plan.dpad, plan.smem,
        1 if vec else 0, _build.stream_ptr(q.device))
    _build.check(err, "paged_attention")
    launches += 1


def read_token_stats(pos: torch.Tensor) -> torch.Tensor:
    """KV tokens attended by one call (the sum over the batch of pos + 1)
    — the ``paged_tokens_read`` counter's per-call increment, a 0-d fp32
    tensor on pos's device (positions are data; nothing is read back)."""
    return torch.sum(pos, dtype=torch.float32) + float(pos.numel())
