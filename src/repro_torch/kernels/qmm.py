"""Grouped-scale quantized matmul W{8,6,4,3}A8, and its two halves.

``qmm`` replaces the TPU kernel ``src/repro/kernels/qmm.py:qmm_pallas``
and ``qmm_groups`` replaces ``qmm_groups_pallas`` (same file), both with
the CUDA kernels of ``csrc/qmm.cu``. On the serving path they are GEMVs
(M <= the slot count), bound by the packed weight bytes.

``qmm_groups`` has one warp per (scale group, 128 columns): it reads each
packed row once, 128 contiguous bytes a warp, unpacks in registers, forms
the group's dot in exact int32 and stores the scaled group terms
``f32(dot[g]) * w_scale[g]`` as (G, M, N) fp32, no group sum — the
shard-local product of a row-parallel block in tensor-parallel serving.
``qmm_groups_fold`` folds such terms in order 0..G-1 and multiplies by
the row's scale once — an order independent of M and of the tiling of M,
so a row served in a batch equals the same row served alone, bit for
bit. ``qmm`` is the two launches on the whole K, so terms gathered from
K-shards that own whole groups fold to ``qmm``'s output bit for bit.

The TPU kernel's ``MAX_GROUP = 4096`` guard is dropped: it bounded one
group's VMEM tile. Here a group's activation slice must fit in shared
memory (checked below); the int32 overflow proof
(``require_group_dot_safe``) stays.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.bounds import require_group_dot_safe
from repro_torch.kernels import ref
from repro_torch.qtensor import logical_size, packed_size

MAX_SMEM = 227 * 1024          # dynamic shared memory one block may use
_MT, _WARPS = 4, 4             # activation rows per warp, warps per block (qmm.cu)
launches = 0                   # qmm (both of its launches)
launches_groups = 0            # qmm_groups
launches_fold = 0              # qmm_groups_fold


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


def smem_bytes(k: int, groups: int) -> int:
    return _WARPS * _MT * (k // groups)


def qmm(x_q: torch.Tensor, w, x_scale: torch.Tensor,
        return_terms: bool = False):
    """x_q: (M, K) int8; ``w``: a 2-D QTensor (K, N) packed along axis 0
    with (G, N) scales; x_scale: (M,) or (M, 1) fp32. Returns (M, N) fp32,
    and with ``return_terms`` also the (G, M, N) fp32 group terms it
    folded (``qmm_groups``' output)."""
    k, n = w.shape
    w_scale = w.scale.reshape(w.scale.shape[w.axis], n)
    groups = _validate("qmm", x_q, w.data, w_scale, w.bits, k)
    if x_q.device.type == "cpu":
        terms = ref.qmm_group_products(x_q, w)
        y = ref.fold_group_terms(terms, x_scale.reshape(-1, 1))
        return (y, terms) if return_terms else y
    _cuda_inputs("qmm", x_q, w, groups, k)
    m = x_q.shape[0]
    x_q = x_q.contiguous()
    xs = x_scale.reshape(-1).to(torch.float32).contiguous()
    if xs.numel() != m:
        raise ValueError(f"qmm: x_scale has {xs.numel()} entries for M={m}")
    wd = w.data.contiguous()
    ws = w_scale.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    terms = torch.empty((groups, m, n), dtype=torch.float32, device=x_q.device)
    if m and n:
        _launch(x_q, xs, wd, ws, out, terms, w.bits, m, k, n, groups)
    return (out, terms) if return_terms else out


def _launch(x_q, xs, wd, ws, out, terms, bits, m, k, n, groups) -> None:
    global launches
    from repro_torch.kernels import _build

    err = _build.lib().qmm_launch(
        x_q.data_ptr(), xs.data_ptr(), wd.data_ptr(), ws.data_ptr(),
        out.data_ptr(), terms.data_ptr(), bits,
        m, k, n, groups, _build.stream_ptr(x_q.device))
    _build.check(err, "qmm")
    launches += 1


def _cuda_inputs(name: str, x_q, w, groups: int, k: int) -> None:
    if x_q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x_q.device}")
    if x_q.dtype != torch.int8 or w.data.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"{name}: dtypes {x_q.dtype} x {w.data.dtype}")
    if smem_bytes(k, groups) > MAX_SMEM:
        raise ValueError(f"{name}: K={k} with {groups} groups needs "
                         f"{smem_bytes(k, groups)} B of shared memory")


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
    x_q = x_q.contiguous()
    wd = w.data.contiguous()
    ws = w_scale.to(torch.float32).contiguous()
    out = torch.empty((groups, m, n), dtype=torch.float32, device=x_q.device)
    if m and n:
        _launch_groups(x_q, wd, ws, out, w.bits, m, k, n, groups)
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


def _launch_groups(x_q, wd, ws, out, bits, m, k, n, groups) -> None:
    global launches_groups
    from repro_torch.kernels import _build

    err = _build.lib().qmm_groups_launch(
        x_q.data_ptr(), wd.data_ptr(), ws.data_ptr(), out.data_ptr(), bits,
        m, k, n, groups, _build.stream_ptr(x_q.device))
    _build.check(err, "qmm_groups")
    launches_groups += 1


def _launch_fold(terms, xs, out, m, n, groups) -> None:
    global launches_fold
    from repro_torch.kernels import _build

    err = _build.lib().qmm_groups_fold_launch(
        terms.data_ptr(), xs.data_ptr(), out.data_ptr(), m, n, groups,
        _build.stream_ptr(terms.device))
    _build.check(err, "qmm_groups_fold")
    launches_fold += 1
