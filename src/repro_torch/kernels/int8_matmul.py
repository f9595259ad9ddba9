"""W8A8 int8 matmul with fused dequantization.

Replaces the TPU kernel
``src/repro/kernels/int8_matmul.py:int8_matmul_pallas`` with the CUDA
kernel of ``csrc/int8_matmul.cu``: ``acc = x_q @ w_q`` in int32 over the
whole K, then ``(f32(acc) * x_scale[m]) * w_scale[n]``. On the serving
path (``--int8 --int8-compute``) it is a GEMV with M <= the slot count,
bound by the (K, N) int8 weight bytes.

One launch a call, no scratch: ``qmm``'s W8 kernel with one scale group
spanning K and this function's own epilogue. A CTA owns 32 output
columns (128 on the head's N) and all of K, its warps split K and form
the dots on the tensor cores (``mma.sync`` s8), add them in shared
memory with integer atomics and apply the epilogue themselves. The int32
accumulation cannot wrap (``require_full_k_safe``), so the order of the
adds does not matter: the result is exact and equal to the plain version
bit for bit. Ragged shapes are masked in the kernel: the weight is never
copied to pad it. ``launch_plan`` sizes the launch.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import torch

from repro_torch.analysis.bounds import require_full_k_safe
from repro_torch.kernels import ref

SMS = 132                      # streaming multiprocessors of the H100 SXM
MAX_WARPS = 16
MAX_WARPS_WIDE = 4             # with 128-column CTAs (the kernel's launch bound)
STEP = 32                      # k values of one step (the mma's depth)
TILE_ROWS = 8                  # activation rows of a CTA tile (the mma's B)
MAX_GRID_Y = 65535
launches = 0


class Int8Plan(NamedTuple):
    cols: int                  # output columns a CTA: 32, or 128 on wide N
    warps: int                 # warps a CTA, splitting K
    steps_per_warp: int        # k32 steps of each warp's contiguous run
    col_tiles: int             # grid.x
    m_tiles: int               # grid.y (a CTA loops past 65,535 tiles)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@lru_cache(maxsize=256)
def launch_plan(m: int, k: int, n: int, sms: int = SMS) -> Int8Plan:
    """The kernel's launch for (M, K) x (K, N) on a card with ``sms`` SMs.
    A lane owns 4 columns, or 16 (one 16-byte load a row) where even
    128-column tiles outnumber two an SM (the head). 16 warps while the
    column tiles fit on the SMs one CTA each (the small projections: each
    SM with a tile keeps 16 warps of loads in flight), 8 while they fit
    two to an SM, else 4 (and at most 4 with 16-column lanes, whose
    registers the kernel caps for 3 CTAs an SM); each warp a run of the
    same number of k32 steps (the kernel gives warp w the steps from
    w * ceil(steps / warps)), and no warp without one."""
    cols = 128 if _cdiv(n, 128) > 2 * sms else 32
    col_tiles = _cdiv(n, cols)
    warps = (MAX_WARPS if col_tiles <= sms else 8 if col_tiles <= 2 * sms
             else 4)
    if cols == 128:
        warps = min(warps, MAX_WARPS_WIDE)
    steps = max(1, _cdiv(k, STEP))
    spw = _cdiv(steps, max(1, min(warps, steps)))
    return Int8Plan(cols, _cdiv(steps, spw), spw, col_tiles,
                    min(_cdiv(m, TILE_ROWS), MAX_GRID_Y))


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _validate(x_q, w_q) -> Tuple[int, int, int]:
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
    return m, k, n


def _scale(s, count: int, dev, what: str) -> torch.Tensor:
    """A scale as a 1-D fp32 tensor of 1 or ``count`` values (a view of an
    fp32 tensor already on ``dev``: no device op)."""
    t = torch.as_tensor(s, dtype=torch.float32, device=dev).reshape(-1)
    if t.numel() not in (1, count):
        raise ValueError(f"int8_matmul: {what} has {t.numel()} entries for "
                         f"{count}")
    return t


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale,
                w_scale) -> torch.Tensor:
    """x_q: (M, K) int8; w_q: (K, N) int8; x_scale: scalar, (M,) or
    (M, 1) fp32; w_scale: scalar, (N,) or (1, N) fp32. Returns (M, N) fp32."""
    m, k, n = _validate(x_q, w_q)
    dev = x_q.device
    xs = _scale(x_scale, m, dev, "x_scale")
    ws = _scale(w_scale, n, dev, "w_scale")
    if dev.type == "cpu":
        return ref.int8_matmul(x_q, w_q, xs.reshape(-1, 1), ws.reshape(1, -1))
    if dev.type != "cuda" or w_q.device != dev:
        raise ValueError(f"int8_matmul: unsupported devices {dev} x {w_q.device}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8_matmul: dtypes {x_q.dtype} x {w_q.dtype}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m and n:
        _launch(x_q.contiguous(), xs.contiguous(), w_q.contiguous(),
                ws.contiguous(), out,
                launch_plan(m, k, n, _sm_count(dev.index or 0)))
    return out


def _launch(x_q, xs, w_q, ws, out, plan: Int8Plan) -> None:
    global launches
    from repro_torch.kernels import _build

    (m, k), n = x_q.shape, w_q.shape[1]
    err = _build.lib().int8_matmul_launch(
        x_q.data_ptr(), xs.data_ptr(), w_q.data_ptr(), ws.data_ptr(),
        out.data_ptr(), m, k, n, plan.cols // 32, plan.warps,
        0 if xs.numel() == 1 else 1, 0 if ws.numel() == 1 else 1,
        _build.stream_ptr(x_q.device))
    _build.check(err, "int8_matmul")
    launches += 1


def activation_saturation(x_q: torch.Tensor):
    """(saturated, total) counts of the int8 activation operand — the
    W8A8 route's clip-rate sample (``qmm.saturation_stats``' twin): a 0-d
    fp32 tensor and a Python float."""
    from repro_torch.kernels.qmm import saturation_stats
    return saturation_stats(x_q)
