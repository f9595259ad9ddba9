"""Fake quantization with a straight-through estimator (port of
``repro.quant.fake_quant``).

``fake_quant_ste`` is the differentiable primitive of QAT graphs:
forward = quantize–dequantize through ``kernels.ops.fake_quant`` (the
CUDA kernels on the card, the plain version on the CPU), backward =
identity to x (Hubara et al. 2016) and no gradient to the scale or the
zero point, which calibration sets outside the autograd graph.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.quant.quantizer import QuantSpec, quant_params


class _FakeQuantSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, zero_point, bits, levels):
        return kops.fake_quant(x, scale, zero_point, bits, levels=levels)

    @staticmethod
    def backward(ctx, g):
        # straight-through: the gradient passes to x unchanged
        return g, None, None, None, None


def fake_quant_ste(x: torch.Tensor, scale, zero_point, bits: int,
                   levels=None) -> torch.Tensor:
    """Quantize–dequantize in the forward, identity in the backward."""
    return _FakeQuantSTE.apply(x, scale, zero_point, bits, levels)


def fake_quant(x: torch.Tensor, spec: QuantSpec,
               scale: Optional[torch.Tensor] = None,
               zero_point: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fake-quantize with the STE; ranges from the data unless given.

    bits >= 16 returns x itself. Per-channel scales are reshaped to
    broadcast along ``spec.channel_axis`` (any axis), and the spec's grid
    bound is passed so symmetric specs clip at 2^b − 2 also for values
    past the calibrated range.
    """
    if spec.bits >= 16:
        return x
    if scale is None or zero_point is None:
        scale, zero_point = quant_params(x.detach(), spec)
    if spec.channel_axis is not None:
        shape = [1] * x.ndim
        shape[spec.channel_axis % x.ndim] = -1
        scale = scale.reshape(shape)
        zero_point = zero_point.reshape(shape)
    return fake_quant_ste(x, scale, zero_point, spec.bits, float(spec.levels))
