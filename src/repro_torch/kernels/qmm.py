"""Grouped-scale quantized matmul W{8,6,4,3}A8.

Replaces the TPU kernel ``src/repro/kernels/qmm.py:qmm_pallas`` with the
CUDA kernels of ``csrc/qmm.cu``. On the serving path it is a GEMV (M <=
the slot count), bound by the packed weight bytes. The first launch has
one warp per (scale group, 128 columns): it reads each packed row once,
128 contiguous bytes a warp, unpacks in registers and forms the group's
dot in exact int32 into a (G, M, N) scratch buffer; the second folds the
scaled group terms in order 0..G-1 — an order independent of M and of
the tiling of M, so a row served in a batch equals the same row served
alone, bit for bit.

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
launches = 0


def _validate(name: str, x_q, w_data, w_scale, bits: int, k: int) -> int:
    """Shape/numerics validation shared by both routes; returns G."""
    m, k_in = x_q.shape
    if k_in != k:
        raise ValueError(f"{name}: x_q {tuple(x_q.shape)} does not match k={k}")
    kp, n = w_data.shape
    if kp != packed_size(k, bits):
        raise ValueError(
            f"{name}: packed payload {tuple(w_data.shape)} inconsistent with "
            f"logical K={k} at {bits} bits "
            f"(expected {packed_size(k, bits)} rows)")
    n_groups = w_scale.shape[0]
    if k % n_groups:
        raise ValueError(f"{name}: {n_groups} scale groups do not divide K={k}")
    bk = k // n_groups
    if logical_size(packed_size(bk, bits), bits) != bk:
        raise ValueError(
            f"{name}: group_size {bk} splits a {bits}-bit pack unit — "
            "quantize with a group size that is a multiple of the pack unit")
    require_group_dot_safe(bits, 8, bk, where=name)
    return n_groups


def smem_bytes(k: int, groups: int) -> int:
    return _WARPS * _MT * (k // groups)


def qmm(x_q: torch.Tensor, w, x_scale: torch.Tensor,
        return_dots: bool = False):
    """x_q: (M, K) int8; ``w``: a 2-D QTensor (K, N) packed along axis 0
    with (G, N) scales; x_scale: (M,) or (M, 1) fp32. Returns (M, N) fp32,
    and with ``return_dots`` also the exact group dots (G, M, N) int64."""
    k, n = w.shape
    w_scale = w.scale.reshape(w.scale.shape[w.axis], n)
    groups = _validate("qmm", x_q, w.data, w_scale, w.bits, k)
    if x_q.device.type == "cpu":
        y = ref.qmm(x_q, w, x_scale.reshape(-1, 1))
        return (y, ref.qmm_group_dots(x_q, w)) if return_dots else y
    if x_q.device.type != "cuda":
        raise ValueError(f"qmm: unsupported device {x_q.device}")
    if x_q.dtype != torch.int8 or w.data.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"qmm: dtypes {x_q.dtype} x {w.data.dtype}")
    if smem_bytes(k, groups) > MAX_SMEM:
        raise ValueError(f"qmm: K={k} with {groups} groups needs "
                         f"{smem_bytes(k, groups)} B of shared memory")
    m = x_q.shape[0]
    x_q = x_q.contiguous()
    xs = x_scale.reshape(-1).to(torch.float32).contiguous()
    if xs.numel() != m:
        raise ValueError(f"qmm: x_scale has {xs.numel()} entries for M={m}")
    wd = w.data.contiguous()
    ws = w_scale.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    dots = torch.empty((groups, m, n), dtype=torch.int32, device=x_q.device)
    if m:
        _launch(x_q, xs, wd, ws, out, dots, w.bits, m, k, n, groups)
    return (out, dots.to(torch.int64)) if return_dots else out


def _launch(x_q, xs, wd, ws, out, dots, bits, m, k, n, groups) -> None:
    global launches
    from repro_torch.kernels import _build

    err = _build.lib().qmm_launch(
        x_q.data_ptr(), xs.data_ptr(), wd.data_ptr(), ws.data_ptr(),
        out.data_ptr(), dots.data_ptr(), bits,
        m, k, n, groups, _build.stream_ptr(x_q.device))
    _build.check(err, "qmm")
    launches += 1
