"""The paper's quantization-noise model (port of ``repro.quant.noise``).

Uniform min–max quantization at bit width ``b`` over [θmin, θmax] has
step ``Δ = (θmax − θmin)/(2^b − 1)`` and noise power ``E[δθ²] = Δ²/12``.
``expected_noise_tree`` evaluates it per parameter block for a bit
configuration — the right-hand factor of FIT.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.utils.pytree import named_leaves


def quant_step(theta_min, theta_max, bits: int):
    """Δ = (θmax − θmin)/(2^b − 1)."""
    return (theta_max - theta_min) / (2.0 ** bits - 1.0)


def noise_power(theta_min, theta_max, bits: int):
    """E[δθ²] = Δ²/12."""
    d = quant_step(theta_min, theta_max, bits)
    return d * d / 12.0


def empirical_noise_power(x: torch.Tensor, fq: torch.Tensor) -> torch.Tensor:
    """Monte-Carlo estimate (1/n)·||Q(θ)−θ||² used to validate Δ²/12."""
    d = (fq - x).to(torch.float32)
    return torch.mean(d * d)


def expected_noise_tree(params, bit_config: Dict[str, int]) -> Dict[str, float]:
    """Per-block noise power for a bit configuration. Blocks missing from
    ``bit_config`` are unquantized (0 noise); ranges are the block's own
    min–max, widened to contain 0 (min–max calibration)."""
    out: Dict[str, float] = {}
    for name, leaf in named_leaves(params):
        bits = bit_config.get(name)
        if bits is None or bits >= 16:
            out[name] = 0.0
            continue
        lo = min(float(torch.min(leaf)), 0.0)
        hi = max(float(torch.max(leaf)), 0.0)
        out[name] = float(noise_power(lo, hi, bits))
    return out
