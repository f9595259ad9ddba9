"""Grouped-scale quantized matmul W{8,6,4,3}A8, and its two halves.

``qmm`` replaces the TPU kernel ``src/repro/kernels/qmm.py:qmm_pallas``
and ``qmm_groups`` replaces ``qmm_groups_pallas`` (same file); both run
the one CUDA kernel of ``csrc/qmm.cu`` in one launch. On the serving path
they are GEMVs (M <= the slot count): a few MB of packed weights, read
once, so latency bounds them, and the bytes on the 95 MB head.

The kernel gives each CTA 32 output columns (128 on the head's N), a
tile of up to 8 activation rows and all of K; its warps split K into
steps of 32 k values of one scale group. A lane reads one 32-bit word of
4 adjacent columns (16 bytes of 16 columns on the head) from each packed
row of its two 4-k units, turns the words into k-contiguous int8 words
with byte permutes (``qmm_core.cuh``, shared with ``grouped_qmm.cu``) and
forms the dots on the tensor cores with ``mma.sync.m16n8k32`` s8. The
warps add their exact int32 group dots in shared memory, and the CTA
folds them in order g = 0..G-1 as the terms ``f32(dot[g]) * w_scale[g]``
and multiplies by the row's scale once. So ``qmm`` is one launch that
writes only its (M, N) output — no (G, M, N) scratch — and
``qmm_groups`` the same launch writing the terms. The order of every
sum is independent of M and of the tiling of M, so a row served in a
batch equals the same row served alone, bit for bit, and terms gathered
from K-shards that own whole groups fold (``qmm_groups_fold``, the
combine of a row-parallel block in tensor-parallel serving) to ``qmm``'s
output bit for bit. ``launch_plan`` sizes the launch.

The TPU kernel's ``MAX_GROUP = 4096`` guard is dropped: it bounded one
group's VMEM tile. The int32 overflow proof (``require_group_dot_safe``)
stays, and the kernel's own bound beside it: it scales 6- and 4-bit
values to the top of their byte, so its dot peaks as W8A8's would.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from repro_torch.analysis.bounds import require_group_dot_safe
from repro_torch.kernels import ref
from repro_torch.qtensor import logical_size, packed_size

MAX_SMEM = 227 * 1024          # dynamic shared memory one block may use
SMS = 132                      # streaming multiprocessors of the H100 SXM
MAX_WARPS = 16
MAX_PASS_GROUPS = 64           # scale groups a CTA holds in shared memory at once
MAX_GRID_Y = 65535
TILE_ROWS = 8                  # activation rows of a CTA tile (the mma's B)
launches = 0                   # qmm
launches_groups = 0            # qmm_groups
launches_fold = 0              # qmm_groups_fold


class QmmPlan(NamedTuple):
    quads: int                 # 4-column quads a lane owns: 1, or 4 on wide N
    warps: int                 # warps per CTA, splitting K
    steps_per_group: int       # k32 steps that cover one group's 4-k units
    pass_groups: int           # groups per pass of a CTA
    col_tiles: int             # grid.x: tiles of 32 * quads columns
    m_tiles: int               # grid.y (a CTA loops past 65,535 tiles)
    smem: int                  # dynamic shared memory per CTA, bytes


@lru_cache(maxsize=256)
def launch_plan(m: int, k: int, n: int, groups: int) -> QmmPlan:
    """The qmm kernel's launch for (M, K) x (K, N) with ``groups`` scale
    groups. A lane owns 4 columns, or 16 (one 16-byte load a packed row)
    where even 128-column tiles outnumber two an SM (the head); so a CTA
    covers 32 or 128 columns. 16 warps while the column tiles fit on the SMs one CTA each (the small projections: every SM
    that has a tile keeps 16 warps of loads in flight), 8 while they fit
    two to an SM, else 4 (and at most 4 with 16-column lanes, whose
    registers the kernel bounds for 128 threads); never more warps than
    (group, step) items; as many groups a pass as shared memory holds, up
    to 64."""
    gs = k // groups
    units = -(-gs // 4) + (1 if gs % 4 else 0)     # 4-k units a group can span
    spg = -(-units // 8)
    quads = 4 if -(-n // 128) > 2 * SMS else 1
    cols = 32 * quads
    col_tiles = -(-n // cols)
    warps = (MAX_WARPS if col_tiles <= SMS else 8 if col_tiles <= 2 * SMS
             else 4)
    warps = max(1, min(warps, MAX_WARPS // quads, groups * spg))
    per_group = min(m, TILE_ROWS) * cols * 4 + cols * 4  # a group's dots, scales
    fixed = 8 * cols * 4 + 8 * 4                  # the running fold, row scales
    pass_groups = min(groups, MAX_PASS_GROUPS, (MAX_SMEM - fixed) // per_group)
    return QmmPlan(quads, warps, spg, pass_groups, col_tiles,
                   min(-(-m // TILE_ROWS), MAX_GRID_Y),
                   fixed + pass_groups * per_group)


def validate_group(name: str, payload_shape, n_groups: int, bits: int,
                   k: int) -> int:
    """Checks of one packed (K*, N) payload with ``n_groups`` scale
    groups along K, shared with ``grouped_qmm``; returns G."""
    kp = payload_shape[0]
    if kp != packed_size(k, bits):
        raise ValueError(
            f"{name}: packed payload {tuple(payload_shape)} inconsistent with "
            f"logical K={k} at {bits} bits "
            f"(expected {packed_size(k, bits)} rows)")
    if k % n_groups:
        raise ValueError(f"{name}: {n_groups} scale groups do not divide K={k}")
    bk = k // n_groups
    if logical_size(packed_size(bk, bits), bits) != bk:
        raise ValueError(
            f"{name}: group_size {bk} splits a {bits}-bit pack unit — "
            "quantize with a group size that is a multiple of the pack unit")
    require_group_dot_safe(bits, 8, bk, where=name)
    return n_groups


def _validate(name: str, x_q, w_data, w_scale, bits: int, k: int) -> int:
    """Shape/numerics validation shared by both routes; returns G."""
    if x_q.ndim != 2 or x_q.shape[1] != k:
        raise ValueError(f"{name}: x_q {tuple(x_q.shape)} does not match k={k}")
    return validate_group(name, w_data.shape, w_scale.shape[0], bits, k)


def qmm(x_q: torch.Tensor, w, x_scale: torch.Tensor,
        return_terms: bool = False):
    """x_q: (M, K) int8; ``w``: a 2-D QTensor (K, N) packed along axis 0
    with (G, N) scales; x_scale: (M,) or (M, 1) fp32. Returns (M, N) fp32,
    and with ``return_terms`` also the (G, M, N) fp32 group terms it
    folded (``qmm_groups``' output, written by the same launch)."""
    k, n = w.shape
    w_scale = w.scale.reshape(w.scale.shape[w.axis], n)
    groups = _validate("qmm", x_q, w.data, w_scale, w.bits, k)
    if x_q.device.type == "cpu":
        terms = ref.qmm_group_products(x_q, w)
        y = ref.fold_group_terms(terms, x_scale.reshape(-1, 1))
        return (y, terms) if return_terms else y
    _cuda_inputs("qmm", x_q, w, groups, k)
    m = x_q.shape[0]
    xs = x_scale.reshape(-1).to(torch.float32).contiguous()
    if xs.numel() != m:
        raise ValueError(f"qmm: x_scale has {xs.numel()} entries for M={m}")
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    terms = (torch.empty((groups, m, n), dtype=torch.float32,
                         device=x_q.device) if return_terms else None)
    if m and n:
        _launch(x_q.contiguous(), xs, w, w_scale, out, terms, groups)
    return (out, terms) if return_terms else out


def _launch(x_q, xs, w, w_scale, out, terms, groups) -> None:
    """One launch of the qmm kernel: ``out`` (M, N) and/or ``terms`` (G,
    M, N) (``None`` for the one not wanted; ``xs`` is read with ``out``)."""
    global launches, launches_groups
    from repro_torch.kernels import _build

    (m, k), n = x_q.shape, w.shape[1]
    wd = w.data.contiguous()
    ws = w_scale.to(torch.float32).contiguous()
    plan = launch_plan(m, k, n, groups)
    err = _build.lib().qmm_launch(
        x_q.data_ptr(), 0 if xs is None else xs.data_ptr(), wd.data_ptr(),
        ws.data_ptr(), 0 if out is None else out.data_ptr(),
        0 if terms is None else terms.data_ptr(), w.bits, m, k, n, groups,
        wd.shape[0], plan.warps, plan.steps_per_group, plan.pass_groups,
        plan.quads, _build.stream_ptr(x_q.device))
    _build.check(err, "qmm" if out is not None else "qmm_groups")
    if out is not None:
        launches += 1
    else:
        launches_groups += 1


def _cuda_inputs(name: str, x_q, w, groups: int, k: int) -> None:
    if x_q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x_q.device}")
    if x_q.dtype != torch.int8 or w.data.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"{name}: dtypes {x_q.dtype} x {w.data.dtype}")
    if (k // groups) * 128 * 128 >= 2**31:
        raise ValueError(f"{name}: group size {k // groups} can overflow the "
                         "kernel's int32 dot (weights scaled into int8)")


def qmm_groups(x_q: torch.Tensor, w) -> torch.Tensor:
    """x_q: (M, K) int8; ``w``: a 2-D QTensor (K, N) packed along axis 0
    with (G, N) scales. Returns the (G, M, N) fp32 terms
    ``f32(exact int32 dot of group g) * w_scale[g]``, no group sum."""
    k, n = w.shape
    w_scale = w.scale.reshape(w.scale.shape[w.axis], n)
    groups = _validate("qmm_groups", x_q, w.data, w_scale, w.bits, k)
    if x_q.device.type == "cpu":
        return ref.qmm_group_products(x_q, w)
    _cuda_inputs("qmm_groups", x_q, w, groups, k)
    m = x_q.shape[0]
    out = torch.empty((groups, m, n), dtype=torch.float32, device=x_q.device)
    if m and n:
        _launch(x_q.contiguous(), None, w, w_scale, None, out, groups)
    return out


def qmm_groups_fold(terms: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """(G, M, N) fp32 group terms and (M,) or (M, 1) fp32 row scales ->
    (M, N) fp32: the left fold over g = 0..G-1, then one multiply by the
    row's scale."""
    if terms.ndim != 3 or terms.dtype != torch.float32:
        raise ValueError(f"qmm_groups_fold: terms {tuple(terms.shape)} "
                         f"{terms.dtype} are not (G, M, N) fp32")
    groups, m, n = terms.shape
    xs = x_scale.reshape(-1).to(torch.float32)
    if xs.numel() != m:
        raise ValueError(f"qmm_groups_fold: x_scale has {xs.numel()} entries "
                         f"for M={m}")
    if terms.device.type == "cpu":
        return ref.fold_group_terms(terms, xs.reshape(m, 1))
    if terms.device.type != "cuda" or xs.device != terms.device:
        raise ValueError(f"qmm_groups_fold: unsupported devices {terms.device} "
                         f"x {xs.device}")
    terms = terms.contiguous()
    xs = xs.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=terms.device)
    if m and n:
        _launch_fold(terms, xs, out, m, n, groups)
    return out


def _launch_fold(terms, xs, out, m, n, groups) -> None:
    global launches_fold
    from repro_torch.kernels import _build

    err = _build.lib().qmm_groups_fold_launch(
        terms.data_ptr(), xs.data_ptr(), out.data_ptr(), m, n, groups,
        _build.stream_ptr(terms.device))
    _build.check(err, "qmm_groups_fold")
    launches_fold += 1
