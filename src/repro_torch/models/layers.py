"""Shared model primitives (port of ``repro.models.layers``): norms, RoPE,
MLPs and initializers. Layers are functional over nested param dicts;
every matmul goes through ``ctx.matmul`` and every activation site
through ``ctx.tap`` (see ``context.py``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def _make(gen: torch.Generator, shape, dtype, scale: float) -> torch.Tensor:
    fan_in = shape[0] if len(shape) > 1 else 1
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * (scale / fan_in ** 0.5)).to(dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 1.0) -> torch.Tensor:
    return _make(gen, (d_in, d_out), dtype, scale)


def init_norm(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


class _GradBarrier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.in_dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.in_dtype)


def grad_barrier(x: torch.Tensor) -> torch.Tensor:
    """Identity whose cotangent is cast back to x's dtype: the SSD's fp32
    accumulations must not hand fp32 cotangents to the projections'
    backward in a bf16 model (the standard bf16-gradient recipe). Where
    no gradient flows (serving) it is x itself: the Function's dispatch
    would cost a host call for nothing."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _GradBarrier.apply(x)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # the mean square is taken in fp32, but only the per-row rsqrt is cast
    # back to x's dtype: x itself never widens
    ms = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return x * inv * gamma


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """theta^(-2i/Dh) in fp32, built on ``device`` by device ops alone: a
    tensor made from host data (``torch.tensor(theta, device=cuda)``)
    would be a pageable host-to-device copy, which synchronizes, in every
    attention layer of every decode step."""
    e = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, e)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) or (S,). Rotates interleaved
    pairs (x[..., ::2], x[..., 1::2]), as the reference does."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    if angles.ndim == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def mlp_apply(x: torch.Tensor, p: Dict[str, torch.Tensor], act: str, ctx) -> torch.Tensor:
    """SwiGLU / GELU / squared-ReLU MLP with quant hooks."""
    if act == "swiglu":
        up = ctx.matmul("w_up", x, p["w_up"])
        gate = F.silu(ctx.matmul("w_gate", x, p["w_gate"]))
        h = ctx.tap("mlp_h", up * gate)
    elif act == "gelu":
        h = ctx.tap("mlp_h", F.gelu(ctx.matmul("w_up", x, p["w_up"]),
                                    approximate="tanh"))
    elif act == "relu2":
        h = F.relu(ctx.matmul("w_up", x, p["w_up"]))
        h = ctx.tap("mlp_h", h * h)
    else:
        raise ValueError(act)
    return ctx.matmul("w_down", h, p["w_down"])


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str, dtype):
    p = {"w_up": init_dense(gen, d_model, d_ff, dtype),
         "w_down": init_dense(gen, d_ff, d_model, dtype)}
    if act == "swiglu":
        p["w_gate"] = init_dense(gen, d_model, d_ff, dtype)
    return p
