"""Per-sample squared-gradient-norm reduction (the EF trace's inner sum).

Replaces the TPU kernel ``src/repro/kernels/ef_sqnorm.py:ef_sqnorm_pallas``
with the CUDA kernel ``csrc/ef_sqnorm.cu``. Bound by bytes on the card:
each gradient element is read once (B·N·2 bytes at bf16) for two flops,
so the kernel runs as fast as the bytes it keeps in flight, at every row
width the main path gives it (2,048 to 786 M elements).

One launch a call. ``launch_plan`` cuts each row into contiguous chunks,
one CTA each: small rows get many CTAs of one step, large rows at most
``MAX_CTAS``. A thread keeps ``unroll`` independent 16-byte loads in
flight, each into its own fp32 accumulator. Each CTA writes its partial;
the last CTA of a row, found through an atomic ticket, folds the row's
partials in chunk order and resets the ticket. The plan depends on N,
the dtype and the alignment alone, and every fold runs in a fixed order
with no float atomics: the same bits on every run, and a (1, N) row has
the bits of that row in a (B, N) call (``core/fisher.py`` relies on it).
Unaligned rows, or N not a whole number of 16-byte vectors, take the
scalar route.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from repro_torch.kernels import ref

THREADS = 256           # threads a CTA; 512 past MAX_CTAS steps
UNROLL = 4              # 16-byte loads a thread has in flight (vector route)
SCALAR_UNROLL = 8       # element loads a thread has in flight (scalar route)
MAX_CTAS = 1024         # chunks a row: the last CTA folds <= 4 partials a thread
MAX_GRID = 2**31 - 1
launches = 0


class EfPlan(NamedTuple):
    vec: int            # elements a load: 16 bytes (8 bf16, 4 fp32), or 1
    threads: int        # threads a CTA
    unroll: int         # independent loads a thread issues a step
    chunk: int          # elements a CTA: a whole number of steps
    ctas: int           # CTAs (chunks) a row


@lru_cache(maxsize=256)
def launch_plan(n: int, dtype: torch.dtype, aligned: bool) -> EfPlan:
    """The kernel's split of one row of N elements: a function of N, the
    dtype and whether the data starts on 16 bytes, never of B or the
    card. A step is ``threads × unroll`` loads of ``vec`` elements. A row
    of up to ``MAX_CTAS`` steps of 256 threads gets a CTA a step (latency:
    one HBM round trip each); a longer row takes 512-thread CTAs of as few
    whole steps as keep it within ``MAX_CTAS`` chunks (fewer, longer CTAs:
    less launch and fold work for the same bytes in flight)."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    vec = v if aligned and n % v == 0 else 1
    unroll = UNROLL if vec > 1 else SCALAR_UNROLL
    threads = THREADS
    if -(-n // (threads * unroll * vec)) > MAX_CTAS:
        threads = 2 * THREADS
    step = threads * unroll * vec
    chunk = -(-max(1, -(-n // step)) // MAX_CTAS) * step
    return EfPlan(vec, threads, unroll, chunk, max(1, -(-n // chunk)))


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
    plan = launch_plan(n, g.dtype, g.data_ptr() % 16 == 0)
    if b * plan.ctas > MAX_GRID:
        raise ValueError(f"ef_sqnorm: {b} rows of {plan.ctas} chunks exceed "
                         "the kernel's grid")
    part = tickets = None
    if plan.ctas > 1:
        part = torch.empty(b * plan.ctas, dtype=torch.float32, device=g.device)
        tickets = _build.ticket_buffer(g.device, b)
    err = _build.lib().ef_sqnorm_launch(
        g.data_ptr(), 1 if g.dtype == torch.bfloat16 else 0, b, n, plan.vec,
        plan.threads, plan.unroll, plan.chunk, plan.ctas,
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), out.data_ptr(),
        _build.stream_ptr(g.device))
    _build.check(err, "ef_sqnorm")
    launches += 1
    return out
