"""Fake quantization (quantize–dequantize), per tensor and per channel.

Replaces the TPU kernels ``src/repro/kernels/fake_quant.py:
fake_quant_pallas`` and ``fake_quant_per_channel_pallas`` with the two
CUDA kernels of ``csrc/fake_quant.cu``. Elementwise and bound by bytes:
x is read once and the output written once, 16 bytes a thread. Scale and
zero point stay on the device (no host sync per call). Per channel, x is
seen as (outer, C, inner), so the channel may be any axis; the TPU
wrapper takes the last one only, and on a square weight with
``channel_axis=0`` it applies the scales along the wrong axis. Both
kernels equal the plain version (``ref.fake_quant``) bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
launches = 0                 # per-tensor kernel
launches_per_channel = 0     # per-channel kernel


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
        _launch_channel(x, out, c, math.prod(x.shape[axis + 1:]),
                        s.reshape(-1).expand(c).contiguous(),
                        zp.reshape(-1).expand(c).contiguous(), lv)
    return out


def _launch_tensor(x, out, s, zp, lv: float) -> None:
    global launches
    from repro_torch.kernels import _build

    err = _build.lib().fake_quant_launch(
        x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], x.numel(),
        s.data_ptr(), zp.data_ptr(), lv, _build.stream_ptr(x.device))
    _build.check(err, "fake_quant")
    launches += 1


def _launch_channel(x, out, c: int, inner: int, s, zp, lv: float) -> None:
    global launches_per_channel
    from repro_torch.kernels import _build

    err = _build.lib().fake_quant_per_channel_launch(
        x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], x.numel(), c, inner,
        s.data_ptr(), zp.data_ptr(), lv, _build.stream_ptr(x.device))
    _build.check(err, "fake_quant_per_channel")
    launches_per_channel += 1
