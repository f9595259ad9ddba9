"""Grouped ragged quantized matmul for MoE serving, W{8,6,4,3}A8.

Replaces the TPU kernel
``src/repro/kernels/grouped_qmm.py:grouped_qmm_pallas`` with the CUDA
kernel of ``csrc/grouped_qmm.cu``: every expert's projection of an MoE
layer in one launch instead of E per-expert ``qmm`` calls. One CTA per
(128 columns, tile of up to 64 rows, segment) walks the scale groups of
its expert in order through a cp.async ring, forms each group's exact
int32 dot on the tensor cores (``mma.sync`` s8, the tensor-core group dot
of ``csrc/qmm_core.cuh``) and folds it in registers with ``qmm``'s
arithmetic, so segment s's valid rows equal the ``qmm`` kernel on
``expert_slice(w, expert_ids[s])`` bit for bit. Bound by the packed bytes
of the experts that have rows, read once per 64 rows; a CTA whose rows
all lie past its segment's count returns before reading a weight byte.
The kernel reads ``counts`` and ``expert_ids`` on the device; nothing
here reads them on the host, so a decode step keeps no sync.

The TPU kernel's ``MAX_GROUP = 4096`` VMEM guard is dropped: a group is
staged in chunks of 128 k values, so any group size runs. Its validation
(``_validate_grouped``) is ported below.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.qmm import validate_group
from repro_torch.qtensor import packed_size

MAX_GRID_Z = 65535
launches = 0


def _validate(name: str, x_q, w, x_scale, counts, expert_ids) -> int:
    """Shape/numerics validation shared by both routes; returns G."""
    if len(w.shape) != 3 or w.data.ndim != 3:
        raise ValueError(f"{name}: w {tuple(w.shape)} is not an (E, K, N) "
                         "expert stack")
    e, k, n = w.shape
    if x_q.ndim != 3 or x_q.shape[2] != k:
        raise ValueError(f"{name}: x_q {tuple(x_q.shape)} is not (S, C, k={k})")
    s, c = x_q.shape[0], x_q.shape[1]
    if w.scale.ndim != 3 or w.scale.shape[0] != e or w.scale.shape[2] != n:
        raise ValueError(
            f"{name}: scales {tuple(w.scale.shape)} are not per-expert "
            f"(E, G, N) for payload {tuple(w.data.shape)} — quantize expert "
            "stacks with qtensor.quantize_experts")
    groups = validate_group(name, w.data.shape[1:], w.scale.shape[1], w.bits, k)
    if tuple(x_scale.shape) != (s, c, 1):
        raise ValueError(f"{name}: x_scale {tuple(x_scale.shape)} is not "
                         f"per-row ({s}, {c}, 1)")
    if tuple(counts.shape) != (s,) or (expert_ids is not None
                                       and tuple(expert_ids.shape) != (s,)):
        raise ValueError(
            f"{name}: counts {tuple(counts.shape)} / expert_ids "
            f"{None if expert_ids is None else tuple(expert_ids.shape)} "
            f"must both be ({s},)")
    return groups


def grouped_qmm(x_q: torch.Tensor, w, x_scale: torch.Tensor,
                counts: torch.Tensor, expert_ids=None,
                return_dots: bool = False):
    """x_q: (S, C, K) int8 segments; ``w``: a ``quantize_experts`` QTensor
    (E, K, N) packed along K with (E, G, N) scales; x_scale: (S, C, 1)
    fp32; counts, expert_ids: (S,) int (ids default to ``arange(S)``).
    Returns (S, C, N) fp32 with rows >= counts[s] exactly 0.0, and with
    ``return_dots`` also the (S, G, C, N) int64 group dots (rows past a
    segment's count are unspecified on the card). On the card the default
    call is one CUDA launch and allocates only its output."""
    groups = _validate("grouped_qmm", x_q, w, x_scale, counts, expert_ids)
    if x_q.device.type == "cpu":
        y = ref.grouped_qmm(x_q, w, x_scale, counts, expert_ids)
        if return_dots:
            return y, ref.grouped_qmm_group_dots(x_q, w, expert_ids)
        return y
    if x_q.device.type != "cuda":
        raise ValueError(f"grouped_qmm: unsupported device {x_q.device}")
    if x_q.dtype != torch.int8 or w.data.dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"grouped_qmm: dtypes {x_q.dtype} x {w.data.dtype}")
    e, k, n = w.shape
    s, c = x_q.shape[0], x_q.shape[1]
    if s > MAX_GRID_Z:
        raise ValueError(f"grouped_qmm: {s} segments exceed the launch grid")
    dev = x_q.device
    ids = (torch.arange(s, dtype=torch.int32, device=dev) if expert_ids is None
           else expert_ids.to(device=dev, dtype=torch.int32).contiguous())
    cnt = counts.to(device=dev, dtype=torch.int32).contiguous()
    x_q = x_q.contiguous()
    xs = x_scale.to(torch.float32).contiguous()
    wd = w.data.contiguous()
    ws = w.scale.to(torch.float32).contiguous()
    out = torch.empty((s, c, n), dtype=torch.float32, device=dev)
    dots = (torch.empty((s, groups, c, n), dtype=torch.int32, device=dev)
            if return_dots else None)
    if s and c:
        _launch(x_q, xs, wd, ws, cnt, ids, out, dots, w.bits, s, c, k, n,
                groups, e, packed_size(k, w.bits) * n)
    return (out, dots.to(torch.int64)) if return_dots else out


def _launch(x_q, xs, wd, ws, cnt, ids, out, dots, bits, s, c, k, n, groups,
            experts, expert_bytes) -> None:
    global launches
    from repro_torch.kernels import _build

    err = _build.lib().grouped_qmm_launch(
        x_q.data_ptr(), xs.data_ptr(), wd.data_ptr(), ws.data_ptr(),
        cnt.data_ptr(), ids.data_ptr(), out.data_ptr(),
        0 if dots is None else dots.data_ptr(),
        bits, s, c, k, n, groups, experts, expert_bytes,
        _build.stream_ptr(x_q.device))
    _build.check(err, "grouped_qmm")
    launches += 1
