"""Flash attention forward (online softmax), causal or full.

Replaces the TPU kernel
``src/repro/kernels/flash_attention.py:flash_attention_pallas`` with the
CUDA kernels of ``csrc/flash_attention.cu``: one block per (batch·head,
64-query tile) loops over double-buffered K/V tiles of 64 keys in shared
memory, keeping the fp32 running max, denominator and accumulator in
registers. Bound by operations at the model's shapes: bf16/fp16 run both
products on the tensor cores (``mma.sync``), fp32 as FMAs on the CUDA
cores.

The semantics are those of the reference's oracle: scale 1/sqrt(D), the
causal mask aligned bottom-right (query i sees keys j <= i + T − S), P
cast to v's dtype before P·V. Causal attention with S > T is refused on
every route: there the oracle returns NaN rows and the Pallas kernel
(mask aligned top-left) attends to keys the oracle masks. Ragged S and T
are masked in the kernel; the TPU wrapper pads them without a mask.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_GRID_Y = 65535
launches = 0


def _validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B, H, S, D) / (B, H, T, D)")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree in B, H or D")
    if causal and q.shape[2] > k.shape[2]:
        raise ValueError(f"flash_attention: causal with S={q.shape[2]} > "
                         f"T={k.shape[2]} would leave query rows with no key")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype} differ")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, H, T, D) -> (B, H, S, D) in q's dtype.
    A CPU tensor takes the plain version; a CUDA tensor the kernel, which
    takes fp32/bf16/fp16 and D in ``HEAD_DIMS``."""
    _validate(q, k, v, causal)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: unsupported devices {q.device}, "
                         f"{k.device}, {v.device}")
    b, h, s, d = q.shape
    t = k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} is not fp32/bf16/fp16")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if b * h > MAX_GRID_Y:
        raise ValueError(f"flash_attention: B*H={b * h} exceeds the grid")
    q, k, v = (_aligned(x.contiguous()) for x in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch(q, k, v, out, b * h, s, t, d, causal)
    return out


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself when its data is 16-byte aligned (cp.async), else a copy."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(q, k, v, out, bh: int, s: int, t: int, d: int,
            causal: bool) -> None:
    global launches
    from repro_torch.kernels import _build

    err = _build.lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], bh, s, t, d, int(causal), 1.0 / (d ** 0.5),
        _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    launches += 1
