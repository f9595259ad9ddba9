"""Per-sample squared-gradient-norm reduction (the EF trace's inner sum).

Replaces the TPU kernel ``src/repro/kernels/ef_sqnorm.py:ef_sqnorm_pallas``
with the CUDA kernel ``csrc/ef_sqnorm.cu``. Bound by bytes on the card:
each gradient element is read once (B·N·2 bytes at bf16) for two flops.
The kernel splits each row into fixed 64Ki-element chunks read 16 bytes
a thread, reduces each in fp32, and adds the chunk partials in a fixed
order in a second pass: no float atomics, the same bits on every run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

CHUNK = 65536
launches = 0


def ef_sqnorm(g: torch.Tensor) -> torch.Tensor:
    """g: (B, N) bf16/fp32 per-sample gradients -> (B,) fp32 squared norms.
    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    if g.device.type == "cpu":
        return ref.ef_sqnorm(g)
    if g.device.type != "cuda":
        raise ValueError(f"ef_sqnorm: unsupported device {g.device}")
    if g.ndim != 2:
        raise ValueError(f"ef_sqnorm: expected (B, N), got {tuple(g.shape)}")
    if g.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ef_sqnorm: dtype {g.dtype} is not bf16/fp32")
    g = g.contiguous()
    b, n = g.shape
    out = torch.empty(b, dtype=torch.float32, device=g.device)
    if b == 0 or n == 0:
        return out.zero_()
    return _launch(g, out)


def _launch(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    global launches
    from repro_torch.kernels import _build

    b, n = g.shape
    nchunks = -(-n // CHUNK)
    partials = torch.empty((b, nchunks), dtype=torch.float32, device=g.device)
    err = _build.lib().ef_sqnorm_launch(
        g.data_ptr(), 1 if g.dtype == torch.bfloat16 else 0, b, n, CHUNK,
        partials.data_ptr(), out.data_ptr(), _build.stream_ptr(g.device))
    _build.check(err, "ef_sqnorm")
    launches += 1
    return out
