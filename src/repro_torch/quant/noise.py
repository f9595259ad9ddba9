"""The paper's quantization-noise model (port of ``repro.quant.noise``).

Uniform min–max quantization at bit width ``b`` over [θmin, θmax] has
step ``Δ = (θmax − θmin)/(2^b − 1)`` and noise power ``E[δθ²] = Δ²/12``.
"""
from __future__ import annotations


def quant_step(theta_min, theta_max, bits: int):
    """Δ = (θmax − θmin)/(2^b − 1)."""
    return (theta_max - theta_min) / (2.0 ** bits - 1.0)


def noise_power(theta_min, theta_max, bits: int):
    """E[δθ²] = Δ²/12."""
    d = quant_step(theta_min, theta_max, bits)
    return d * d / 12.0
