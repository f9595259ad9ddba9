"""Fake quantization (quantize–dequantize), per tensor and per channel.

Replaces the TPU kernels ``src/repro/kernels/fake_quant.py:
fake_quant_pallas`` and ``fake_quant_per_channel_pallas`` with the two
CUDA kernels of ``csrc/fake_quant.cu``. Elementwise and bound by bytes:
x is read once and the output written once, 16 bytes a thread. Scale and
zero point stay on the device (no host sync per call). Per channel, x is
seen as (outer, C, inner), so the channel may be any axis; the TPU
wrapper takes the last one only, and on a square weight with
``channel_axis=0`` it applies the scales along the wrong axis. The
per-channel grid is channel-stationary: ``launch_plan`` picks the route
(a thread owning a 16-byte column vector and walking rows for the last
axis, whole runs of one channel for a long inner stride, the
element-wise walk otherwise), so a thread makes each channel's grid
once. Both kernels equal the plain version (``ref.fake_quant``) bit for
bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROUTE_WALK, ROUTE_ROWS, ROUTE_RUNS = 0, 1, 2
THREADS = 256                # a block of the per-channel kernels
WALK_MAX_BLOCKS = 4096       # the walk's grid-stride loop
# grid sizes, from a sweep on the H100 (256..4096 blocks): the rows route
# gains from more rows a thread (its V grids made once), the runs route
# from more runs in flight
ROWS_TARGET_BLOCKS = 256
RUNS_TARGET_BLOCKS = 2048
RUN_LOADS = 4                # a runs thread's loads a run, where it can
MAX_GRID_Y = 65535
MIN_RUN_UNITS = 32           # a run takes at least a warp's worth of loads
launches = 0                 # per-tensor kernel
launches_per_channel = 0     # per-channel kernel


class FqPlan(NamedTuple):
    route: int                 # ROUTE_WALK, ROUTE_ROWS or ROUTE_RUNS
    vec: bool                  # 16-byte vectors (else one element a load)
    tx: int                    # threads a block along a row or run
    ty: int                    # rows or runs a block takes at a time
    blocks_x: int
    blocks_y: int


def _threads_for(units: int) -> int:
    """Threads along a row: the least power of two >= units, from a warp
    to a block."""
    return min(THREADS, max(32, 1 << (units - 1).bit_length()))


def _threads_for_run(units: int) -> int:
    """Threads along a run: the greatest power of two with ``RUN_LOADS``
    loads each, from a warp to a block."""
    return min(THREADS, max(32, 1 << max(0, (units // RUN_LOADS).bit_length() - 1)))


def launch_plan(shape, axis: int, dtype: torch.dtype,
                aligned: bool = True) -> FqPlan:
    """The per-channel kernel's route and launch sizes for x of ``shape``
    with channels along ``axis``; ``aligned``: x and the output both start
    on 16 bytes. The last axis (inner == 1) takes the rows route: a thread
    owns one 16-byte column vector (or one channel, where a row is not a
    whole number of 16-byte vectors or a pointer is unaligned) and walks
    rows. An inner stride of at least ``MIN_RUN_UNITS`` loads takes the
    runs route: whole runs of one channel. Anything else takes the
    element-wise walk."""
    shape = tuple(int(d) for d in shape)
    axis %= len(shape)
    n, c = math.prod(shape), shape[axis]
    inner = math.prod(shape[axis + 1:])
    v = 16 // torch.empty((), dtype=dtype).element_size()
    if inner == 1:
        vec = aligned and c % v == 0
        units = c // v if vec else c
        tx = _threads_for(units)
        ty = THREADS // tx
        bx = -(-units // tx)
        by = min(-(-(n // c) // ty), max(1, ROWS_TARGET_BLOCKS // bx), MAX_GRID_Y)
        return FqPlan(ROUTE_ROWS, vec, tx, ty, bx, by)
    vec = aligned and inner % v == 0
    units = inner // v if vec else inner
    if units >= MIN_RUN_UNITS:
        tx = _threads_for_run(units)
        ty = THREADS // tx
        return FqPlan(ROUTE_RUNS, vec, tx, ty,
                      min(-(-(n // inner) // ty), RUNS_TARGET_BLOCKS), 1)
    work = n // v + 16 if aligned else n
    return FqPlan(ROUTE_WALK, aligned, THREADS, 1,
                  max(1, min(WALK_MAX_BLOCKS, -(-work // THREADS))), 1)


def channel_axis(x: torch.Tensor, scale: torch.Tensor,
                 zero_point: torch.Tensor) -> Optional[int]:
    """The axis of x the per-channel ``scale``/``zero_point`` run along
    (they broadcast against x with one non-unit axis), or None when both
    are single values (per tensor)."""
    if scale.numel() == 1 and zero_point.numel() == 1:
        return None
    shape = torch.broadcast_shapes(scale.shape, zero_point.shape)
    if len(shape) > x.ndim:
        raise ValueError(f"fake_quant: scale {tuple(shape)} has more axes "
                         f"than x {tuple(x.shape)}")
    shape = (1,) * (x.ndim - len(shape)) + tuple(shape)
    axes = [d for d, n in enumerate(shape) if n != 1]
    if len(axes) != 1 or shape[axes[0]] != x.shape[axes[0]]:
        raise ValueError(f"fake_quant: scale/zero point {tuple(shape)} are "
                         f"not per-channel along one axis of x "
                         f"{tuple(x.shape)}")
    return axes[0]


def fake_quant(x: torch.Tensor, scale, zero_point, bits: int,
               levels=None) -> torch.Tensor:
    """x: any shape, fp32/bf16/fp16; scale, zero_point: scalars (per
    tensor) or tensors broadcast against x along one axis (per channel).
    ``levels``: the largest grid index (default 2^bits − 1). Returns x's
    shape and dtype. A CPU tensor takes the plain version; a CUDA tensor
    one of the two kernels."""
    # rpr-ok: RPR004 levels is a python number (a grid size), not a tensor
    lv = 2.0 ** bits - 1.0 if levels is None else float(levels)
    dev = x.device
    s = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    zp = torch.as_tensor(zero_point, dtype=torch.float32, device=dev)
    axis = channel_axis(x, s, zp)
    if dev.type == "cpu":
        return ref.fake_quant(x, s, zp, bits, lv)
    if dev.type != "cuda" or s.device != dev or zp.device != dev:
        raise ValueError(f"fake_quant: unsupported devices {dev}, {s.device}, "
                         f"{zp.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fake_quant: dtype {x.dtype} is not fp32/bf16/fp16")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if axis is None:
        _launch_tensor(x, out, s.reshape(1).contiguous(),
                       zp.reshape(1).contiguous(), lv)
    else:
        c = x.shape[axis]
        plan = launch_plan(x.shape, axis, x.dtype,
                           x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        _launch_channel(x, out, c, math.prod(x.shape[axis + 1:]),
                        s.reshape(-1).expand(c).contiguous(),
                        zp.reshape(-1).expand(c).contiguous(), lv, plan)
    return out


def _launch_tensor(x, out, s, zp, lv: float) -> None:
    global launches
    from repro_torch.kernels import _build

    err = _build.lib().fake_quant_launch(
        x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], x.numel(),
        s.data_ptr(), zp.data_ptr(), lv, _build.stream_ptr(x.device))
    _build.check(err, "fake_quant")
    launches += 1


def _launch_channel(x, out, c: int, inner: int, s, zp, lv: float,
                    plan: FqPlan) -> None:
    global launches_per_channel
    from repro_torch.kernels import _build

    err = _build.lib().fake_quant_per_channel_launch(
        x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], x.numel(), c, inner,
        s.data_ptr(), zp.data_ptr(), lv, plan.route, int(plan.vec), plan.tx,
        plan.ty, plan.blocks_x, plan.blocks_y, _build.stream_ptr(x.device))
    _build.check(err, "fake_quant_per_channel")
    launches_per_channel += 1


def clip_stats(x: torch.Tensor, scale, zero_point, bits: int, levels=None):
    """(clipped, total) counts of one fake-quant call: how many grid
    indices ``round(x / scale + zp)`` fell outside [0, levels] and were
    clamped (the reference's formula, a division). The first is a 0-d
    fp32 tensor on x's device, the second a Python float; scale and
    zero point may be numbers or tensors on x's device (no host copy).
    Feeds the ``fq_clip`` / ``fq_elems`` counters."""
    # rpr-ok: RPR004 levels is a python number (a grid size), not a tensor
    lv = (2.0 ** bits - 1.0) if levels is None else float(levels)
    q = torch.round(x.to(torch.float32) / scale + zero_point)
    clipped = torch.sum((q < 0.0) | (q > lv), dtype=torch.float32)
    return clipped, float(x.numel())  # rpr-ok: RPR004 numel() is a python int
