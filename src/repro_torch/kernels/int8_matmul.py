"""W8A8 int8 matmul with fused dequantization.

Replaces the TPU kernel
``src/repro/kernels/int8_matmul.py:int8_matmul_pallas`` with the CUDA
kernel of ``csrc/int8_matmul.cu``: ``acc = x_q @ w_q`` in int32 over the
whole K, then ``(f32(acc) * x_scale[m]) * w_scale[n]``. On the serving
path (``--int8 --int8-compute``) it is a GEMV with M <= the slot count,
bound by the (K, N) int8 weight bytes. The int32 accumulation cannot
wrap (``require_full_k_safe``), so the kernel splits K across blocks and
adds the partial sums in any order; the result is exact and equal to the
plain version bit for bit. Ragged shapes are masked in the kernel: the
weight is never copied to pad it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.analysis.bounds import require_full_k_safe
from repro_torch.kernels import ref

COLS, MT, WARPS, BATCH = 128, 4, 8, 32   # block tile of csrc/int8_matmul.cu
MAX_GRID_Z = 65535
launches = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_split(m: int, k: int, n: int, sms: int) -> Tuple[int, int]:
    """(chunk, ksplit): K rows per block (a multiple of 32) and the number
    of K splits. Split until about two blocks per SM are in flight, but
    keep at least one 32-row batch per warp in a split."""
    tiles = _cdiv(n, COLS) * _cdiv(m, MT)
    want = max(1, min(_cdiv(2 * sms, tiles), _cdiv(k, WARPS * BATCH)))
    chunk = _cdiv(_cdiv(k, want), BATCH) * BATCH
    return chunk, _cdiv(k, chunk)


def _validate(x_q, w_q, w_scale) -> Tuple[int, int, int]:
    if x_q.ndim != 2 or w_q.ndim != 2:
        raise ValueError(f"int8_matmul: x_q {tuple(x_q.shape)} and w_q "
                         f"{tuple(w_q.shape)} must be matrices")
    m, k = x_q.shape
    k2, n = w_q.shape
    if k != k2:
        raise ValueError(f"int8_matmul: reduction dims disagree (x_q "
                         f"{tuple(x_q.shape)}, w_q {tuple(w_q.shape)})")
    # the int32 accumulator spans the FULL K axis: prove it cannot wrap
    require_full_k_safe(8, 8, k, where="int8_matmul")
    n_ws = torch.as_tensor(w_scale).numel()
    if n_ws not in (1, n):
        raise ValueError(f"int8_matmul: w_scale has {n_ws} entries for N={n}")
    return m, k, n


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale,
                w_scale) -> torch.Tensor:
    """x_q: (M, K) int8; w_q: (K, N) int8; x_scale: scalar, (M,) or
    (M, 1) fp32; w_scale: scalar, (N,) or (1, N) fp32. Returns (M, N) fp32."""
    m, k, n = _validate(x_q, w_q, w_scale)
    dev = x_q.device
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=dev).reshape(-1)
    if xs.numel() == 1:
        xs = xs.expand(m)
    if xs.numel() != m:
        raise ValueError(f"int8_matmul: x_scale has {xs.numel()} entries "
                         f"for M={m}")
    ws = torch.as_tensor(w_scale, dtype=torch.float32, device=dev).reshape(-1)
    if ws.numel() == 1:
        ws = ws.expand(n)
    if dev.type == "cpu":
        return ref.int8_matmul(x_q, w_q, xs.reshape(m, 1), ws.reshape(1, n))
    if dev.type != "cuda" or w_q.device != dev:
        raise ValueError(f"int8_matmul: unsupported devices {dev} x {w_q.device}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8_matmul: dtypes {x_q.dtype} x {w_q.dtype}")
    if _cdiv(m, MT) > MAX_GRID_Z:
        raise ValueError(f"int8_matmul: M={m} exceeds the grid")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m and n and k:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        chunk, ksplit = plan_split(m, k, n, sms)
        acc = (torch.zeros((m, n), dtype=torch.int32, device=dev)
               if ksplit > 1 else None)
        _launch(x_q.contiguous(), xs.contiguous(), w_q.contiguous(),
                ws.contiguous(), out, acc, m, k, n, chunk, ksplit)
    else:
        out.zero_()
    return out


def _launch(x_q, xs, w_q, ws, out, acc, m, k, n, chunk, ksplit) -> None:
    global launches
    from repro_torch.kernels import _build

    err = _build.lib().int8_matmul_launch(
        x_q.data_ptr(), xs.data_ptr(), w_q.data_ptr(), ws.data_ptr(),
        out.data_ptr(), None if acc is None else acc.data_ptr(),
        m, k, n, chunk, ksplit, _build.stream_ptr(x_q.device))
    _build.check(err, "int8_matmul")
    launches += 1
