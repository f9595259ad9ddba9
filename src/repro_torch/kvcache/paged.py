"""Device-side paged KV storage (port of ``repro.kvcache.paged``).

Each attention layer owns a ``(P, page, KV, Dh')`` pool for k and v, at
its own bit width: fp at 16 bits, int8 at 8/7/5, packed uint8 at 6/4/3
(the QTensor byte layout along Dh), with per-page per-kv-head fp32
scales ``(P, KV)`` from the report's calibrated activation ranges.
Pools are written in place, copy-on-write page copies too.

Under tensor-parallel serving the pools shard by kv head
(``ShardedPages``): shard i holds heads [i·KV/n, (i+1)·KV/n) with their
scales on the mesh's device i, and every function here that takes a
layer's pool takes either form.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.qtensor import (
    PACKED_BITS, bytes_per_element, logical_size, pack, packed_size,
    qmax_for_bits, quantize_values, unpack)

# Fallback |activation| max when no calibrated range is supplied
DEFAULT_KV_AMAX = 6.35


def kv_layer_count(cfg: ModelConfig) -> int:
    """Number of attention layers holding KV state."""
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        return cfg.num_layers
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_period
    return 0


@dataclasses.dataclass
class LayerPages:
    """One attention layer's page pool. ``k``/``v`` are the P pages the
    reads see; ``k_buf``/``v_buf`` are the same storage plus one spare
    page at index P that takes the writes the reference drops, so a write
    needs no host sync to filter them out."""

    k: torch.Tensor          # (P, page, KV, Dh) fp/int8 | (P, page, KV, Dh') uint8
    v: torch.Tensor
    k_scale: torch.Tensor    # (P, KV) fp32 per-page per-kv-head scale
    v_scale: torch.Tensor
    k_buf: torch.Tensor      # (P + 1, page, KV, Dh')
    v_buf: torch.Tensor
    bits: int = 16

    @property
    def num_pages(self) -> int:
        return self.k.shape[0]

    @property
    def page_size(self) -> int:
        return self.k.shape[1]


@dataclasses.dataclass
class ShardedPages:
    """One attention layer's pool split by kv head across a TPMesh:
    ``shards[i]`` holds heads [i·KV/n, (i+1)·KV/n) and their (P, KV/n)
    scales on ``mesh.devices[i]``. Every kv head is independent (scores,
    softmax and the value contraction never mix heads), so each shard
    writes and reads its heads alone."""

    shards: List[LayerPages]
    mesh: Any                # launch.mesh.TPMesh

    @property
    def num_pages(self) -> int:
        return self.shards[0].num_pages

    @property
    def page_size(self) -> int:
        return self.shards[0].page_size

    @property
    def bits(self) -> int:
        return self.shards[0].bits

    def heads(self, i: int) -> slice:
        """The kv heads shard i holds."""
        kvl = self.shards[0].k.shape[2]
        return slice(i * kvl, (i + 1) * kvl)


Pool = Union[LayerPages, ShardedPages]


class PagedState(NamedTuple):
    """Paged KV component of a decode state (slots share one pool)."""

    layers: Dict[str, Pool]         # attn-layer index (as str) -> pool
    table: torch.Tensor             # (S, NP) int32; entries >= P = unmapped
    write_limit: torch.Tensor       # (S,) int32 — positions >= limit drop


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    """Static shape of a paged KV cache pool."""

    page_size: int
    num_pages: int
    pages_per_slot: int
    kv_bits: Tuple[int, ...]

    @classmethod
    def build(cls, cfg: ModelConfig, max_len: int, slots: int,
              page_size: int = 16, num_pages: Optional[int] = None,
              kv_bits=None) -> "PagedKVConfig":
        """``kv_bits``: None/int uniform, or {layer index -> bits}."""
        n = kv_layer_count(cfg)
        if n == 0:
            raise ValueError(f"family {cfg.family!r} holds no KV cache")
        if max_len % page_size:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of page_size "
                f"({page_size}) — the paged-vs-dense parity contract needs "
                "equal attention spans")
        if kv_bits is None:
            bits = (16,) * n
        elif isinstance(kv_bits, int):
            bits = (kv_bits,) * n
        else:
            bits = tuple(int(kv_bits.get(i, kv_bits.get(str(i), 16)))
                         for i in range(n))
        for b in bits:
            if b in PACKED_BITS and logical_size(packed_size(cfg.head_dim, b),
                                                 b) != cfg.head_dim:
                raise ValueError(
                    f"packed {b}-bit KV needs head_dim ({cfg.head_dim}) "
                    "divisible by its pack unit")
        nps = max_len // page_size
        return cls(page_size=page_size,
                   num_pages=num_pages if num_pages else slots * nps,
                   pages_per_slot=nps, kv_bits=bits)


def _scale_from_ranges(ranges, site: str, bits: int) -> float:
    if ranges is not None and site in ranges:
        lo, hi = ranges[site]
        amax = max(abs(float(lo)), abs(float(hi)), 1e-8)
    else:
        amax = DEFAULT_KV_AMAX
    return amax / qmax_for_bits(bits)


def kv_sites_for_layer(cfg: ModelConfig, i: int) -> Tuple[str, str]:
    """Scoped tap paths of layer ``i``'s k/v activation sites."""
    base = f"shared/{i}/attn" if cfg.family == "hybrid" else f"layers/{i}/attn"
    return f"{base}/k", f"{base}/v"


def _layer_pages(pcfg: PagedKVConfig, bits: int, kvh: int, hd: int,
                 fp_dtype, k_scale: float, v_scale: float,
                 dev: torch.device) -> LayerPages:
    if bits >= 16:
        dtype, last = fp_dtype, hd
    elif bits in PACKED_BITS:
        dtype, last = torch.uint8, packed_size(hd, bits)
    else:
        dtype, last = torch.int8, hd
    shape = (pcfg.num_pages + 1, pcfg.page_size, kvh, last)
    kb = torch.zeros(shape, dtype=dtype, device=dev)
    vb = torch.zeros_like(kb)
    return LayerPages(
        k=kb[:pcfg.num_pages], v=vb[:pcfg.num_pages], k_buf=kb, v_buf=vb,
        k_scale=torch.full((pcfg.num_pages, kvh), k_scale,
                           dtype=torch.float32, device=dev),
        v_scale=torch.full((pcfg.num_pages, kvh), v_scale,
                           dtype=torch.float32, device=dev),
        bits=bits)


def init_paged_kv(cfg: ModelConfig, pcfg: PagedKVConfig, slots: int,
                  ranges: Optional[Mapping[str, Tuple[float, float]]] = None,
                  device=None, mesh=None) -> PagedState:
    """Zeroed pools + unmapped page tables on ``device``; with a
    ``mesh`` (a TPMesh whose size divides the kv heads) each layer's
    pool is a ``ShardedPages`` over the mesh's devices."""
    dev = resolve_device(device)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    layers: Dict[str, Pool] = {}
    for i, bits in enumerate(pcfg.kv_bits):
        ksite, vsite = kv_sites_for_layer(cfg, i)
        scales = (_scale_from_ranges(ranges, ksite, bits),
                  _scale_from_ranges(ranges, vsite, bits))
        if mesh is None:
            layers[str(i)] = _layer_pages(pcfg, bits, kv, hd, cfg.param_dtype,
                                          *scales, dev)
        else:
            layers[str(i)] = ShardedPages(
                [_layer_pages(pcfg, bits, kv // mesh.size, hd,
                              cfg.param_dtype, *scales, d)
                 for d in mesh.devices], mesh)
    return PagedState(
        layers=layers,
        table=torch.full((slots, pcfg.pages_per_slot), pcfg.num_pages,
                         dtype=torch.int32, device=dev),
        write_limit=torch.zeros(slots, dtype=torch.int32, device=dev))


def quantize_kv(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Float (..., KV, Dh) -> page storage at ``bits``; scale (..., KV)."""
    q = quantize_values(x, scale[..., None], bits)
    return pack(q, bits, axis=-1) if bits in PACKED_BITS else q


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of ``quantize_kv`` (fp32 output)."""
    return unpack(q, bits).to(torch.float32) * scale[..., None]


def gather_layer(lp: Pool, row: torch.Tensor, n_tokens: int,
                 out_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Page row -> dense (NP*page, KV, Dh) k and v spans, zero past
    ``n_tokens`` (the prefix-reuse read: it seeds a dense scratch state
    so suffix prefill attends to a shared prefix without recomputing it).
    A sharded pool's heads are gathered back in head order on the lead
    device: the scratch state is replicated."""
    if isinstance(lp, ShardedPages):
        parts = [gather_layer(sh, row.to(d), n_tokens, out_dtype)
                 for sh, d in zip(lp.shards, lp.mesh.devices)]
        return (lp.mesh.all_gather([k for k, _ in parts], dim=1),
                lp.mesh.all_gather([v for _, v in parts], dim=1))
    ids = torch.clamp(row.to(torch.int64), 0, lp.num_pages - 1)
    kg, vg = lp.k[ids], lp.v[ids]                  # (NP, page, KV, Dh')
    if lp.bits < 16:
        kg = dequantize_kv(kg, lp.k_scale[ids][:, None, :], lp.bits)
        vg = dequantize_kv(vg, lp.v_scale[ids][:, None, :], lp.bits)
    t = row.shape[0] * lp.page_size
    kg = kg.reshape((t,) + tuple(kg.shape[2:])).to(out_dtype)
    vg = vg.reshape((t,) + tuple(vg.shape[2:])).to(out_dtype)
    valid = (torch.arange(t, device=kg.device) < n_tokens)[:, None, None]
    return (torch.where(valid, kg, torch.zeros_like(kg)),
            torch.where(valid, vg, torch.zeros_like(vg)))


def copy_page(lp: Pool, src: int, dst: int) -> Pool:
    """Physical page copy, the copy-on-write primitive, in place (on
    every shard of a sharded pool). It writes through ``k``/``v`` (views
    of ``k_buf``/``v_buf``), so the spare page for dropped writes stays
    where it is."""
    if isinstance(lp, ShardedPages):
        for sh in lp.shards:
            copy_page(sh, src, dst)
        return lp
    lp.k[dst] = lp.k[src]
    lp.v[dst] = lp.v[src]
    lp.k_scale[dst] = lp.k_scale[src]
    lp.v_scale[dst] = lp.v_scale[src]
    return lp


def write_tokens(lp: LayerPages, pid: torch.Tensor, off: torch.Tensor,
                 kq: torch.Tensor, vq: torch.Tensor) -> None:
    """Write page rows (pid, off) <- kq/vq in place. Rows with
    ``pid >= num_pages`` are dropped (the reference's ``mode="drop"``):
    they land in the spare page, which no read sees."""
    pid = torch.clamp(pid, max=lp.num_pages)
    lp.k_buf[pid, off] = kq
    lp.v_buf[pid, off] = vq


def scatter_span(lp: Pool, row: torch.Tensor, k_span: torch.Tensor,
                 v_span: torch.Tensor, start: int, stop: int) -> Pool:
    """Write dense tokens [start, stop) of (T, KV, Dh) spans into the
    pages of ``row`` (the admission insert), in place; a sharded pool
    takes each shard's heads on its device."""
    if isinstance(lp, ShardedPages):
        for i, (sh, d) in enumerate(zip(lp.shards, lp.mesh.devices)):
            hs = lp.heads(i)
            scatter_span(sh, row.to(d), k_span[:, hs].to(d),
                         v_span[:, hs].to(d), start, stop)
        return lp
    t = k_span.shape[0]
    pos = torch.arange(t, device=k_span.device)
    cols = torch.clamp(pos // lp.page_size, 0, row.shape[0] - 1)
    valid = (pos >= start) & (pos < stop)
    pids = torch.where(valid, row.to(torch.int64)[cols],
                       torch.full_like(pos, lp.num_pages))
    sp = torch.clamp(pids, max=lp.num_pages - 1)
    if lp.bits < 16:
        kq = quantize_kv(k_span, lp.k_scale[sp], lp.bits)
        vq = quantize_kv(v_span, lp.v_scale[sp], lp.bits)
    else:
        kq, vq = k_span.to(lp.k.dtype), v_span.to(lp.v.dtype)
    write_tokens(lp, pids, pos % lp.page_size, kq, vq)
    return lp


# ---------------------------------------------------------------------------
# HBM accounting
# ---------------------------------------------------------------------------

def _bytes_per_elem(cfg: ModelConfig, bits: int) -> float:
    fp = torch.empty((), dtype=cfg.param_dtype).element_size()
    return bytes_per_element(bits, fp)


def layer_page_bytes(cfg: ModelConfig, page_size: int, bits: int) -> float:
    """Bytes of ONE page (k + v) of one layer at ``bits``."""
    elems = page_size * cfg.num_kv_heads * cfg.head_dim
    return 2 * elems * _bytes_per_elem(cfg, bits)


def page_bytes_all_layers(cfg: ModelConfig, pcfg: PagedKVConfig) -> float:
    return sum(layer_page_bytes(cfg, pcfg.page_size, b) for b in pcfg.kv_bits)


def pool_bytes(cfg: ModelConfig, pcfg: PagedKVConfig) -> float:
    """Total HBM of the paged pools (scales excluded)."""
    return pcfg.num_pages * page_bytes_all_layers(cfg, pcfg)


def per_shard_pool_bytes(cfg: ModelConfig, pcfg: PagedKVConfig,
                         tp_shards: int = 1) -> float:
    """HBM one device holds for the paged pools under tensor-parallel
    serving: pools shard by kv head when ``num_kv_heads % tp_shards ==
    0`` (each shard stores 1/tp of every page), else they replicate and
    every device pays the full pool."""
    total = pool_bytes(cfg, pcfg)
    if tp_shards > 1 and cfg.num_kv_heads % tp_shards == 0:
        return total / tp_shards
    return total


def dense_kv_bytes(cfg: ModelConfig, slots: int, max_len: int,
                   bits: int = 16) -> float:
    """HBM of the dense per-slot cache this subsystem replaces."""
    n = kv_layer_count(cfg)
    elems = slots * max_len * cfg.num_kv_heads * cfg.head_dim
    return n * 2 * elems * _bytes_per_elem(cfg, bits)
