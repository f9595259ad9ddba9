"""Flash attention forward (online softmax), causal or full, any head dim.

Replaces the TPU kernel
``src/repro/kernels/flash_attention.py:flash_attention_pallas`` with the
CUDA kernels of ``csrc/flash_attention.cu``. Bound by operations at the
model's shapes. bf16/fp16 run a warp-specialised Hopper kernel:
persistent CTAs (one an SM) walk (batch·head, 128-query) work tiles,
causal ones heaviest first; a producer warpgroup loads each tile's Q and
its K/V tiles by TMA into 2-stage mbarrier rings, and two consumer
warpgroups of 64 query rows form both products with ``wgmma`` (P fed
from registers) and the softmax in registers (``ex2``), each overlapping
a tile's softmax with the previous tile's P·V and taking turns with the
other to issue. fp32 runs FMAs on the CUDA cores (the tensor cores would
take it as TF32).

Any head dim D <= 256 runs at a kernel width (``width_plan``): the least
of ``KERNEL_WIDTHS`` >= D, with the columns past D zero. The kernel
reads q, k and v in place when a row of D elements is a whole number of
16-byte chunks (D % 8 == 0 in 16 bits, D % 4 == 0 in fp32; the TMA or
cp.async zero-fills the rest of the width), and otherwise takes copies
zero-padded to the width. The scale stays 1/sqrt(D) of the true D and
only the first D output columns are written. No configuration has a head
dim past 256. There, bf16/fp16 up to D = 512 run the same Hopper design
with the head dim split between the two consumer warpgroups: both take
the same 64 query rows, each forms its half of the scores from its half
of Q and K, the halves are added through shared memory, and each
accumulates its half of O. Its width is the least of ``SPLIT_WIDTHS``
>= D, with the same rule for reading in place as up to 256. fp32 up to
512 runs a CUDA-core kernel at the true D that stages Q once and streams
K and V in chunks, over 128-column slabs of the output on small grids
and over all its columns (the scores formed once) on large ones. Past
512 every dtype runs a CUDA-core kernel at the true D: one block per
128-column slab of the output, each forming the scores over the full D
in staged chunks. ``kernel_for`` names the kernel of a planned width and
the launcher runs that kernel, or refuses the call.

The semantics are those of the reference's oracle: scale 1/sqrt(D), the
causal mask aligned bottom-right (query i sees keys j <= i + T − S), P
cast to v's dtype before P·V. Causal attention with S > T is refused on
every route: there the oracle returns NaN rows and the Pallas kernel
(mask aligned top-left) attends to keys the oracle masks. Ragged S and T
are masked in the kernel; the TPU wrapper pads them without a mask.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref

KERNEL_WIDTHS = (32, 64, 96, 128, 256)
SPLIT_WIDTHS = (320, 384, 448, 512)  # bf16/fp16 past 256: the split-head-dim kernel
F32_WIDE_MAX_D = 512           # fp32 past 256 up to here: its wide CUDA-core kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernels of csrc/flash_attention.cu, by the number the launcher takes
KERNELS = ("wgmma", "split", "f32", "f32_wide", "wide")
MAX_GRID_Y = 65535             # the CUDA-core kernels' query tiles (64 rows) per head
launches = 0
launches_by_kernel = dict.fromkeys(KERNELS, 0)


def kernel_for(width: int, dtype: torch.dtype) -> str:
    """The kernel that runs a call at a planned width: in bf16/fp16 the
    ``wgmma`` kernel up to 256 and the split-head-dim one up to 512; in
    fp32 the CUDA-core ``f32`` kernel up to 256 and ``f32_wide`` up to
    512; past 512 the wide CUDA-core kernel in every dtype."""
    if width > (F32_WIDE_MAX_D if dtype == torch.float32 else SPLIT_WIDTHS[-1]):
        return "wide"
    if dtype == torch.float32:
        return "f32" if width <= KERNEL_WIDTHS[-1] else "f32_wide"
    return "wgmma" if width <= KERNEL_WIDTHS[-1] else "split"


def width_plan(d: int, dtype: torch.dtype) -> tuple[int, bool]:
    """(kernel width, whether q, k and v are copied zero-padded to it) for
    head dim ``d``: the least of ``KERNEL_WIDTHS`` >= d, and in bf16/fp16
    past 256 the least of ``SPLIT_WIDTHS``, with the inputs read in place
    when a row of d elements is a whole number of 16-byte chunks (what the
    TMA and cp.async take); past those (fp32 past 256, any dtype past
    512) a CUDA-core kernel runs at d itself and reads the inputs in
    place."""
    if d < 1:
        raise ValueError(f"flash_attention: head dim {d} < 1")
    widths = KERNEL_WIDTHS if dtype == torch.float32 else KERNEL_WIDTHS + SPLIT_WIDTHS
    if d > widths[-1]:
        return d, False
    width = next(w for w in widths if w >= d)
    esize = torch.empty((), dtype=dtype).element_size()
    return width, (d * esize) % 16 != 0


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
    takes fp32/bf16/fp16 and any D."""
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
    width, padded = width_plan(d, q.dtype)
    kernel = kernel_for(width, q.dtype)
    if kernel not in ("wgmma", "split") and -(-s // 64) > MAX_GRID_Y:
        raise ValueError(f"flash_attention: S={s} exceeds the CUDA-core "
                         "kernel's grid")
    if padded:
        q, k, v = (F.pad(x, (0, width - d)).contiguous() for x in (q, k, v))
    else:
        q, k, v = (_aligned(x.contiguous()) for x in (q, k, v))
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _launch(q, k, v, out, kernel, b * h, s, t, d, q.shape[3], width, causal)
    return out


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself when its data is 16-byte aligned (TMA, cp.async), else a copy."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(q, k, v, out, kernel: str, bh: int, s: int, t: int, d: int,
            ld: int, width: int, causal: bool) -> None:
    global launches
    from repro_torch.kernels import _build

    err = _build.lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], KERNELS.index(kernel), bh, s, t, d, ld, width,
        int(causal), 1.0 / (d ** 0.5), _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    launches += 1
    launches_by_kernel[kernel] += 1
