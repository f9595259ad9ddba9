"""Analytic QTensor cost model: closed-form bytes-moved and op counts
per serving kernel, from the REAL packed layouts (port of
``repro.obs.perf.cost``, against the H100's machine balance).

Every byte count here is derived from the same formulas the storage
layer realizes — ``packed_size`` for payloads, fp32 scale grids shaped
exactly like ``quantize``/``LayerPages`` shape them — so for any
quantized block the model's weight bytes equal
``storage_summary([block])["packed_bytes"]`` to the byte (pinned by
``tests/test_torch_perf.py``).  That exactness is the point: the roofline
this module emits is an *accounting* of the serving configuration, not
an estimate of it.

Per decode step, each matmul site streams its resident operand once
(weights + scales), reads int8 activations with per-row scales, and
writes an fp32 accumulator tile; ``paged_attention`` streams the
attended K/V pages at the KV cache's packed width.  Composed across a
parameter tree (``site_costs_from_tree``) this gives a per-site
roofline — memory- vs compute-bound against the machine balance — that
``obs.perf.attrib`` joins with measured dispatch times and FIT
scores.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Union

import torch

from repro_torch.qtensor import (
    QTensor, bytes_per_element, is_qtensor, packed_size)

# machine balance: the NVIDIA H100 SXM's published dense peaks — bf16
# tensor-core FLOP/s, int8 tensor-core OP/s, HBM3 bandwidth in bytes/s
# (``chip_smoke.py`` bounds its kernels with the same three numbers) —
# and its NVLink 4 bandwidth in bytes/s a direction (900 GB/s both ways;
# ``launch.roofline``'s collective term). Spec-sheet figures, not
# measurements.
PEAK_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Closed-form cost of one kernel dispatch at one site.

    ``bytes_weight`` is the resident operand (packed payload + fp32
    scales) streamed from HBM; ``bytes_act``/``bytes_out`` are the
    streaming input/output tiles.  Ops are split by unit because the
    tensor cores run int8 at twice the bf16 rate.
    """

    site: str
    kind: str            # "qmm" | "grouped_qmm" | "int8_matmul" |
                         # "fp_matmul" | "paged_attention"
    bits: int
    bytes_weight: float
    bytes_act: float
    bytes_out: float
    int_ops: float
    fp_ops: float

    @property
    def bytes(self) -> float:
        return self.bytes_weight + self.bytes_act + self.bytes_out

    @property
    def ops(self) -> float:
        return self.int_ops + self.fp_ops

    @property
    def intensity(self) -> float:
        """Ops per byte moved — compare against the machine balance."""
        return self.ops / max(self.bytes, 1e-12)

    def times(self, hbm_bw: float = HBM_BW, peak_flops: float = PEAK_FLOPS,
              int8_ops: float = INT8_OPS) -> Dict[str, float]:
        mem_s = self.bytes / hbm_bw
        comp_s = self.fp_ops / peak_flops + self.int_ops / int8_ops
        return {"memory_s": mem_s, "compute_s": comp_s,
                "kernel_s": max(mem_s, comp_s),
                "bound": "memory" if mem_s >= comp_s else "compute"}


def qmm_weight_bytes(k: int, n: int, bits: int,
                     group_size: Optional[int] = None) -> float:
    """Resident bytes of a packed W{bits} (k, n) qmm weight: payload at
    the packed row size plus the (k/group, n) fp32 scale grid —
    identical to ``storage_summary``'s packed_bytes for that block."""
    if bits >= 16:
        raise ValueError("qmm weights are quantized (< 16 bits)")
    gs = k if group_size is None else min(group_size, k)
    payload = packed_size(k, bits) * n          # 1 B per packed element
    return float(payload + (k // gs) * n * 4)


def qmm_cost(site: str, m: int, k: int, n: int, bits: int,
             group_size: Optional[int] = None) -> KernelCost:
    """One W{bits}A8 qmm dispatch of an (m, k) @ (k, n) site: int8
    activations with per-row fp32 scales in, fp32 tile out, 2mkn int
    MACs plus a per-(row, out, group) fp scale fold."""
    gs = k if group_size is None else min(group_size, k)
    groups = k // gs
    return KernelCost(
        site=site, kind="qmm", bits=bits,
        bytes_weight=qmm_weight_bytes(k, n, bits, group_size),
        bytes_act=float(m * k + m * 4),
        bytes_out=float(m * n * 4),
        int_ops=2.0 * m * k * n,
        fp_ops=2.0 * m * n * groups)


def grouped_qmm_weight_bytes(e: int, k: int, n: int, bits: int,
                             group_size: Optional[int] = None) -> float:
    """Resident bytes of a packed (E, K, N) ``quantize_experts`` stack:
    E payloads at the packed row size plus the (E, K/group, N) fp32
    per-expert scale grid — exactly E x ``qmm_weight_bytes`` of one
    expert, and byte-equal to ``storage_summary``'s packed_bytes for
    the stack (pinned by ``tests/test_torch_perf.py``)."""
    return float(e) * qmm_weight_bytes(k, n, bits, group_size)


def grouped_qmm_cost(site: str, e: int, c: int, k: int, n: int, bits: int,
                     group_size: Optional[int] = None) -> KernelCost:
    """One grouped ragged dispatch over E capacity-``c`` segments: the
    WHOLE packed expert stack streams once — that is the kernel's point;
    the dense per-expert loop pays the same weight bytes across E
    dispatch latencies — plus E*c int8 activation rows with per-row
    scales in and an (E, c, N) fp32 tile out.  Op counts assume full
    segments (the roofline upper bound: ragged tails and empty experts
    only SKIP tensor-core tiles, they never add work)."""
    gs = k if group_size is None else min(group_size, k)
    groups = k // gs
    m = e * c
    return KernelCost(
        site=site, kind="grouped_qmm", bits=bits,
        bytes_weight=grouped_qmm_weight_bytes(e, k, n, bits, group_size),
        bytes_act=float(m * k + m * 4),
        bytes_out=float(m * n * 4),
        int_ops=2.0 * m * k * n,
        fp_ops=2.0 * m * n * groups)


def int8_matmul_cost(site: str, m: int, k: int, n: int) -> KernelCost:
    """Legacy W8A8 path: dense int8 weight + per-channel fp32 scales."""
    return KernelCost(
        site=site, kind="int8_matmul", bits=8,
        bytes_weight=float(k * n + n * 4),
        bytes_act=float(m * k + m * 4),
        bytes_out=float(m * n * 4),
        int_ops=2.0 * m * k * n,
        fp_ops=2.0 * m * n)


def fp_matmul_cost(site: str, m: int, k: int, n: int,
                   itemsize: float = 2.0) -> KernelCost:
    """Unquantized matmul site at the param dtype width."""
    return KernelCost(
        site=site, kind="fp_matmul", bits=int(8 * itemsize),
        bytes_weight=float(k * n * itemsize),
        bytes_act=float(m * k * itemsize),
        bytes_out=float(m * n * itemsize),
        int_ops=0.0,
        fp_ops=2.0 * m * k * n)


def paged_attention_cost(site: str, batch: int, context: int, kv_heads: int,
                         head_dim: int, q_heads: int, bits: int,
                         page_size: int,
                         fp_bytes: float = 2.0) -> KernelCost:
    """One decode-step GQA read over ``context`` attended tokens per
    sequence: K+V streamed at the KV cache's packed width (plus the
    touched pages' per-(page, head) fp32 scales when quantized), one q
    vector in, one attended vector out, QK^T + PV flops.  Dequantize
    happens in-register — the dots are counted as fp ops."""
    per_tok = 2.0 * kv_heads * head_dim * bytes_per_element(bits, fp_bytes)
    pages = -(-context // page_size) if page_size else 0
    scales = 2.0 * pages * kv_heads * 4.0 if bits < 16 else 0.0
    return KernelCost(
        site=site, kind="paged_attention", bits=bits,
        bytes_weight=float(batch * (context * per_tok + scales)),
        bytes_act=float(batch * q_heads * head_dim * fp_bytes),
        bytes_out=float(batch * q_heads * head_dim * 4),
        int_ops=0.0,
        fp_ops=4.0 * batch * context * q_heads * head_dim)


def kv_pool_bytes(num_pages: int, page_size: int, kv_heads: int,
                  head_dim: int, bits: int, fp_bytes: float = 2.0) -> float:
    """Resident bytes of one layer's (k, v) page pools.  For bits < 16
    this equals ``storage_summary([lp.k_qt, lp.v_qt])["packed_bytes"]``
    of a live ``LayerPages`` exactly: payload at ``packed_size`` along
    the head dim, plus the (P, 1, KV, 1) fp32 scale grids."""
    if bits >= 16:
        return 2.0 * num_pages * page_size * kv_heads * head_dim * fp_bytes
    payload = num_pages * page_size * kv_heads * packed_size(head_dim, bits)
    return 2.0 * (payload + num_pages * kv_heads * 4.0)


def site_costs_from_tree(params: Any, m: int, *, context: int = 0,
                         kv_bits: int = 16, page_size: int = 16,
                         cfg: Any = None,
                         fp_bytes: float = 2.0) -> Dict[str, KernelCost]:
    """Per-site decode-step costs of a (possibly quantized) parameter
    tree at batch ``m``: every 2-D matmul leaf becomes a qmm /
    int8_matmul / fp_matmul cost keyed by its '/'-joined tree path (the
    same keys ``SensitivityReport`` uses); 3-D packed expert stacks
    become one ``grouped_qmm`` row at the layer's MoE capacity (from
    ``cfg``'s capacity_factor/top_k when given, else segments of ``m``);
    and with ``cfg`` + ``context`` one ``paged_attention`` site is added
    per layer at the KV cache's width."""
    from repro_torch.serve.quantized import MATMUL_LEAVES
    from repro_torch.utils.pytree import named_leaves

    costs: Dict[str, KernelCost] = {}
    for name, leaf in named_leaves(params, is_leaf=is_qtensor):
        tail = name.split("/")[-1]
        if tail not in MATMUL_LEAVES:
            continue
        if isinstance(leaf, QTensor):
            if leaf.ndim == 3:
                # packed MoE expert stack: one grouped ragged dispatch at
                # the layer's capacity-sorted segment shape
                e, k, n = leaf.shape
                cap = m
                if cfg is not None and getattr(cfg, "num_experts", 0):
                    cap = int(cfg.capacity_factor * m * cfg.top_k / e
                              + 0.999)
                costs[name] = grouped_qmm_cost(
                    name, e, max(cap, 1), k, n, leaf.bits, leaf.group_size)
                continue
            if leaf.ndim != 2:
                continue
            k, n = leaf.shape
            costs[name] = qmm_cost(name, m, k, n, leaf.bits, leaf.group_size)
        elif getattr(leaf, "ndim", 0) == 2:
            k, n = leaf.shape
            if leaf.dtype == torch.int8:
                costs[name] = int8_matmul_cost(name, m, k, n)
            else:
                costs[name] = fp_matmul_cost(
                    name, m, k, n, itemsize=leaf.element_size())
    if cfg is not None and context > 0:
        dh = cfg.head_dim or cfg.d_model // cfg.num_heads
        for i in range(cfg.num_layers):
            site = f"layers/{i}/attn/paged_attention"
            costs[site] = paged_attention_cost(
                site, m, context, cfg.num_kv_heads, dh, cfg.num_heads,
                kv_bits, page_size, fp_bytes)
    return costs


def roofline(costs: Mapping[str, KernelCost], hbm_bw: float = HBM_BW,
             peak_flops: float = PEAK_FLOPS,
             int8_ops: float = INT8_OPS) -> Dict[str, Any]:
    """Per-site and total roofline of one decode step: each kernel runs
    at max(memory time, compute time); kernels are sequential, so the
    step bound is the sum of per-site maxima."""
    sites: Dict[str, Dict[str, Union[str, float, int]]] = {}
    tot_bytes = tot_int = tot_fp = step_s = 0.0
    n_mem = 0
    for name, c in costs.items():
        t = c.times(hbm_bw, peak_flops, int8_ops)
        sites[name] = {"kind": c.kind, "bits": c.bits, "bytes": c.bytes,
                       "int_ops": c.int_ops, "fp_ops": c.fp_ops,
                       "intensity": c.intensity, **t}
        tot_bytes += c.bytes
        tot_int += c.int_ops
        tot_fp += c.fp_ops
        step_s += t["kernel_s"]
        n_mem += t["bound"] == "memory"
    return {"sites": sites,
            "totals": {"bytes": tot_bytes, "int_ops": tot_int,
                       "fp_ops": tot_fp, "step_time_s": step_s,
                       "memory_bound_sites": n_mem,
                       "compute_bound_sites": len(sites) - n_mem}}
