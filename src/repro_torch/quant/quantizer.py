"""Uniform quantizers, affine and symmetric, per-tensor or per-channel
(port of ``repro.quant.quantizer``).

The paper's quantization model (Appendix E): uniform min–max
quantization with step ``Δ = (θmax − θmin)/(2^b − 1)``.

Grid conventions, as in the reference:

  * affine (default) — 2^b levels indexed [0, 2^b−1], the zero point
    wherever 0.0 lands (the paper's min–max grid);
  * symmetric — an odd number of values, 2^b − 1, indexed [0, 2^b−2],
    with the zero point at the integer 2^(b−1)−1. That is the
    ±(2^(b−1)−1) storage grid of every packed QTensor, so symmetric
    fake-quant simulates packed serving exactly.

Arithmetic runs in the input's dtype, as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of one quantizer.

    Attributes:
      bits: bit width (2..8 typical; 16/32 = effectively no-op).
      symmetric: symmetric (zero_point at the grid's centre, range
        ±max|θ|) vs affine min–max.
      channel_axis: per-channel scales along this axis; None = per-tensor.
    """

    bits: int = 8
    symmetric: bool = False
    channel_axis: Optional[int] = None

    @property
    def levels(self) -> int:
        """Largest grid index: 2^b − 1 (affine) or 2^b − 2 (symmetric)."""
        return 2 ** self.bits - (2 if self.symmetric else 1)


def quant_range(x: torch.Tensor, spec: QuantSpec
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) statistics at the spec's granularity."""
    if spec.channel_axis is None:
        lo, hi = torch.amin(x), torch.amax(x)
    else:
        axes = tuple(i for i in range(x.ndim)
                     if i != spec.channel_axis % x.ndim)
        lo, hi = torch.amin(x, dim=axes), torch.amax(x, dim=axes)
    if spec.symmetric:
        m = torch.maximum(torch.abs(lo), torch.abs(hi))
        return -m, m
    # affine: the grid must contain 0 so that zero maps exactly
    return torch.clamp_max(lo, 0.0), torch.clamp_min(hi, 0.0)


def quant_params(x: torch.Tensor, spec: QuantSpec
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale Δ = (max − min)/levels and the zero point, the integer grid
    index 0.0 maps to (exactly 2^(b−1)−1 for symmetric specs)."""
    lo, hi = quant_range(x, spec)
    scale = (hi - lo) / spec.levels
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)  # constant tensor
    zero_point = torch.round(-lo / scale)
    return scale, zero_point


def _reshape_per_channel(s: torch.Tensor, x: torch.Tensor,
                         axis: int) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[axis % x.ndim] = -1
    return s.reshape(shape)


def quantize(x: torch.Tensor, scale: torch.Tensor, zero_point: torch.Tensor,
             spec: QuantSpec) -> torch.Tensor:
    """Real -> integer grid (still float dtype; values in [0, levels])."""
    if spec.channel_axis is not None:
        scale = _reshape_per_channel(scale, x, spec.channel_axis)
        zero_point = _reshape_per_channel(zero_point, x, spec.channel_axis)
    q = torch.round(x / scale + zero_point)
    return torch.clamp(q, 0.0, float(spec.levels))


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               zero_point: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    if spec.channel_axis is not None:
        scale = _reshape_per_channel(scale, q, spec.channel_axis)
        zero_point = _reshape_per_channel(zero_point, q, spec.channel_axis)
    return (q - zero_point) * scale


def fake_quant_ref(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Quantize–dequantize in one shot (no straight-through gradient)."""
    if spec.bits >= 16:
        return x
    scale, zp = quant_params(x, spec)
    return dequantize(quantize(x, scale, zp, spec), scale, zp, spec).to(x.dtype)


# ---------------------------------------------------------------------------
# QTensor round trips: QuantSpec -> packed storage -> values
# ---------------------------------------------------------------------------

def to_qtensor(x: torch.Tensor, spec: QuantSpec,
               group_size: Optional[int] = None):
    """Quantize ``x`` under a symmetric ``spec`` into packed QTensor
    storage. Per-tensor specs store one scale; per-channel specs need the
    channel on the last axis and take an optional ``group_size`` along
    the reduction axis. The grid is the one symmetric fake-quant
    simulates, so ``from_qtensor(to_qtensor(x, spec)) ==
    fake_quant_ref(x, spec)`` for per-tensor specs."""
    from repro_torch import qtensor as qt
    if not spec.symmetric:
        raise ValueError("packed QTensor storage is symmetric; use an "
                         "affine spec only for fake-quant simulation")
    if spec.channel_axis is None:
        amax = torch.amax(torch.abs(x.to(torch.float32)))
        scale = (torch.clamp_min(amax, 1e-12)
                 / qt.qmax_for_bits(spec.bits)).reshape((1,) * x.ndim)
        return qt.quantize(x, spec.bits, scale=scale)
    if spec.channel_axis % x.ndim != x.ndim - 1:
        raise ValueError("QTensor stores per-channel scales on the LAST "
                         f"axis; got channel_axis={spec.channel_axis}")
    return qt.quantize(x, spec.bits, group_size=group_size)


def from_qtensor(qt_tensor, dtype=None) -> torch.Tensor:
    """Unpack and dequantize a QTensor back to values."""
    return qt_tensor.dequantize(dtype if dtype is not None else torch.float32)
