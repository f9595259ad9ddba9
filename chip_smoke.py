"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --only flash_attention,grouped_qmm  # those checks only

Phases, in order; any failure exits non-zero:
  1. print the card and its power limit; build the CUDA kernels from
     src/repro_torch/kernels/csrc with nvcc for sm_90a (one nvcc per
     source, all started together);
  2. hold every kernel (qmm_groups and its fold included) against its
     plain PyTorch version on the card at
     the main paths' shapes, and time kernel, plain version and the one
     PyTorch library call computing the same function (CUDA events);
     check that one serving call of qmm, int8_matmul and paged_attention
     is one launch with no allocation but its output (and the paged
     partials where a context spans CTAs), and that paged_attention's
     slots alone and its kv-head shards equal the batched, full call;
     that each flash row runs the kernel its head dim and dtype plan
     (bf16/fp16 past D = 256: the split-head-dim kernel up to 512, one
     launch with no input copy when a row is whole 16-byte chunks), and
     that every route of the per-channel fake-quant plan is checked;
  3a. the packed paged decode of the internlm2_1_8b, olmoe_1b_7b and
     deepseek_moe_16b smoke configs on the card against the CPU plain path;
  3b. drive each main path at full width — internlm2_1_8b (dense) and
     olmoe_1b_7b (MoE, grouped_qmm) — seeded init -> FIT report -> W4/W8
     bit allocation -> packed QTensors -> FIT KV widths -> paged serving
     of Poisson requests (greedy), with every kernel launch counter reset
     just before each path and read just after its serving run;
  3c. the serving CLI's path at full width: repro_torch.launch.serve.serve()
     on internlm2_1_8b with int8-backed W8 weights through int8_matmul,
     paged int8 KV with a 24-token shared prefix (prefix sharing and a
     copy-on-write page), counters reset just before it and read just
     after; then the sharing contract at full width (paged bf16 pages
     with sharing == the dense cache == paged without sharing), and the
     CLI itself (python -m repro_torch.launch.serve --smoke ...) in a
     subprocess;
  3d. the quantization library at full width (internlm2_1_8b): activation
     ranges calibrated with MinMaxObserver/EmaObserver, every weight block
     and activation fake-quantized through the STE (fake_quant and
     fake_quant_per_channel, held bit for bit against the plain version),
     and flash_attention on layer 0's causal q, k, v against the model's
     chunked attention; counters reset just before and read just after;
  3e. QAT training (W4A8) of internlm2_1_8b at full width and depth
     through launch.train.train, the resume contract at full width and 2
     layers, and the training CLI in a subprocess;
  3f. (run right after 3b, on its params) tensor-parallel serving on this
     one card: internlm2_1_8b at the tp=1 mesh and at tp=2 (two shards
     on cuda:0), streams identical to 3b's plain engine; olmoe_1b_7b at
     tp=2 with expert parallelism; the CLI's int8-backed params at tp=2;
     a decode-step A/B of plain, tp=1 and tp=2 in turns;
  3g. (run right after 3f, on 3b's params and report) sampled and
     self-speculative serving: a 5-token decode equals 5 one-token steps
     bit for bit (int8_compute on and off, paged and dense); sampled
     streams deterministic, alone == batched, tp=2 == tp=1; speculative
     streams (k = 4, a draft from allocate_draft_bits at 3 bits; paged
     with 4-bit draft pools, dense with the int8 lane; greedy and
     sampled) equal the plain engine's, and olmoe_1b_7b's (k = 3,
     non-binding capacity); the CLI's int8-backed path sampled and
     speculative, in process and in a subprocess; tok/s in turns, the
     accept rate beside the FIT proxies, the sampler's cost;
  4. print the kernels line and the main-path metrics;
  5. print {"ok": true, "device": {...}} as the last line.

Writes the full measurement table to chiprun_out/chip_smoke.json.
Imports torch and the port only.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM published peaks (dense)
FP32_FLOPS = 67e12
INT8_OPS = 1979e12


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of one call, with L2 flushed before each
    repetition (the serving loop finds weights and pages cold). A 1 ms
    device spin before the start event keeps the card busy while the host
    enqueues the call, so the events bracket device time only, not the
    Python wrapper's launch latency."""

    def __init__(self, reps: int = 10):
        self.reps = reps
        self.flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(self.reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            ts.append(s.elapsed_time(e))
        return statistics.median(ts)


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def check_ef_sqnorm(timer, gen, rows):
    from repro_torch.kernels import ef_sqnorm as kmod, ref

    for n in (16_777_216, 189_530_112):        # mlp block; embed/head block
        g = torch.randn((4, n), generator=gen, device="cuda",
                        dtype=torch.float32).mul_(1e-3).to(torch.bfloat16)
        got = kmod.ef_sqnorm(g)
        want = ref.ef_sqnorm(g)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=1e-4, atol=0):
            raise AssertionError(f"ef_sqnorm (4, {n}): {got} vs {want}")
        b_ms, b_by = bound_ms(4 * n * 2 + 16, 2 * 4 * n, FP32_FLOPS)
        row = {"kernel": "ef_sqnorm", "shape": f"(4, {n}) bf16",
               "max_abs_err": err,
               "rel_err": (err / want.abs().max().item()),
               "ms": timer(lambda: kmod.ef_sqnorm(g)),
               "plain_ms": timer(lambda: ref.ef_sqnorm(g)),
               "library_ms": timer(lambda: g.float().square().sum(1)),
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(json.dumps(row))
        del g


QMM_SHAPES = [("wq/wo", 2048, 2048), ("wk/wv", 2048, 1024),
              ("w_up/w_gate", 2048, 8192), ("w_down", 8192, 2048),
              ("head", 2048, 92544)]


def check_one_launch(kmod, xq, qt, xs) -> dict:
    """One serving-path qmm call (no terms) is one launch of the qmm
    kernel, no other kernel of the module, and one allocation: its (M, N)
    output, no (G, M, N) scratch."""
    y, launched, allocs, nbytes = count_call(
        lambda: kmod.qmm(xq, qt, xs),
        [lambda: kmod.launches, lambda: kmod.launches_groups,
         lambda: kmod.launches_fold])
    if launched != (1, 0, 0) or allocs != 1 or nbytes < y.numel() * 4 \
            or nbytes >= y.numel() * 4 + 512 * 1024:
        raise AssertionError(f"qmm serving call: launches (qmm, qmm_groups, "
                             f"fold) {launched}, {allocs} allocations of "
                             f"{nbytes} B for a {tuple(y.shape)} fp32 output")
    return {"launches": launched[0], "allocations": allocs,
            "allocated_bytes": nbytes}


def check_qmm(timer, gen, rows):
    """qmm against its plain version (terms ``torch.equal``, the output
    within 1e-5) and its one-launch contract."""
    from repro_torch.kernels import qmm as kmod, ref
    from repro_torch.qtensor import quantize

    for name, k, n in QMM_SHAPES:
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        for bits in (8, 6, 4, 3):
            qt = quantize(w, bits, group_size=128)
            wd = qt.dequantize(torch.bfloat16)
            for m in (1, 4):
                xq = torch.randint(-127, 128, (m, k), generator=gen,
                                   device="cuda", dtype=torch.int32).to(torch.int8)
                xs = torch.rand(m, generator=gen, device="cuda") * 0.02 + 1e-3
                y, terms = kmod.qmm(xq, qt, xs, return_terms=True)
                want_terms = ref.qmm_group_products(xq, qt)
                want = ref.qmm(xq, qt, xs.reshape(-1, 1))
                torch.cuda.synchronize()
                if not torch.equal(terms, want_terms):
                    raise AssertionError(f"qmm {name} W{bits} M={m}: group "
                                         "terms (exact int32 dots, one "
                                         "rounding) differ from the plain "
                                         "version")
                scale = want.abs().max().item()
                err = (y - want).abs().max().item()
                if not torch.allclose(y, want, rtol=1e-5, atol=1e-5 * scale):
                    raise AssertionError(f"qmm {name} W{bits} M={m}: max "
                                         f"err {err} (max|y| {scale})")
                nbytes = (qt.data.numel() + qt.scale.numel() * 4 + m * k
                          + m * 4 + m * n * 4)
                b_ms, b_by = bound_ms(nbytes, 2.0 * m * k * n, INT8_OPS)
                xb = (xq.float() * xs[:, None]).to(torch.bfloat16)
                row = {"kernel": "qmm", "shape": f"{name} {k}x{n} W{bits} M={m}",
                       "bits": bits, "m": m, "max_abs_err": err,
                       "ms": timer(lambda: kmod.qmm(xq, qt, xs)),
                       "plain_ms": timer(lambda: ref.qmm(xq, qt, xs.reshape(-1, 1))),
                       "library_ms": timer(lambda: torch.matmul(xb, wd)),
                       "bound_ms": b_ms, "bound_by": b_by}
                if (name, bits, m) == ("wq/wo", 8, 4):
                    row["one_launch"] = check_one_launch(kmod, xq, qt, xs)
                rows.append(row)
                log(json.dumps(row))
            del qt, wd
        del w


# (name, K, N, bits, M, group size): wo and w_down of internlm2_1_8b at
# group 128, at tp=1 and at their tp=2 shard-local K, at M=4 (a decode
# step of 4 slots) and M=1 (every prefill token: the engine prefills one
# token a step); a ragged M=3; a stress M=32 the path never gives (4
# tiles in one launch); 6- and 3-bit payloads; a ragged N (not a multiple
# of 4: the byte-wise load path); zamba2_7b's w_down (G=112: more groups
# than a CTA's pass holds, so the fold runs in two passes); and a group of
# 120 (not a whole number of k32 steps: the kernel's checked path)
QMM_GROUPS_SHAPES = [("wo", 2048, 2048, 8, 4, 128),
                     ("w_down", 8192, 2048, 4, 4, 128),
                     ("wo tp=2 shard", 1024, 2048, 8, 4, 128),
                     ("w_down tp=2 shard", 4096, 2048, 4, 4, 128),
                     ("wo", 2048, 2048, 8, 1, 128),
                     ("w_down", 8192, 2048, 4, 1, 128),
                     ("wo tp=2 shard", 1024, 2048, 8, 1, 128),
                     ("w_down tp=2 shard", 4096, 2048, 4, 1, 128),
                     ("wo ragged M", 2048, 2048, 8, 3, 128),
                     ("wo stress M", 2048, 2048, 8, 32, 128),
                     ("wo", 2048, 2048, 6, 4, 128),
                     ("wo", 2048, 2048, 3, 4, 128),
                     ("ragged", 1024, 1027, 4, 4, 128),
                     ("zamba2 w_down", 14336, 3584, 8, 4, 128),
                     ("zamba2 w_down", 14336, 3584, 8, 1, 128),
                     ("zamba2 w_down", 14336, 3584, 4, 4, 128),
                     ("zamba2 w_down", 14336, 3584, 4, 1, 128),
                     ("group 120", 1920, 2048, 8, 4, 120),
                     ("group 120", 1920, 2048, 8, 1, 120)]


def check_qmm_groups(timer, gen, rows):
    """qmm_groups against its plain version with ``torch.equal`` (exact
    int32 dots, one rounding of the scale product) at the shapes the
    tensor-parallel path gives it, and at a two-pass G and a group size
    that is not a multiple of 32; shard invariance (the terms of a
    K-slice owning whole groups are that slice of the full terms); and
    qmm_groups_fold of the terms ``torch.equal`` to the qmm kernel and
    to the plain fold."""
    from repro_torch.kernels import qmm as kmod, ref
    from repro_torch.qtensor import quantize, shard

    for name, k, n, bits, m, gs in QMM_GROUPS_SHAPES:
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        qt = quantize(w, bits, group_size=gs)
        groups = k // gs
        xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.int8)
        xs = torch.rand(m, generator=gen, device="cuda") * 0.02 + 1e-3
        tag = f"qmm_groups {name} {k}x{n} W{bits} G={groups} M={m}"
        terms = kmod.qmm_groups(xq, qt)
        want = ref.qmm_group_products(xq, qt)
        torch.cuda.synchronize()
        if not torch.equal(terms, want):
            err = (terms - want).abs().max().item()
            raise AssertionError(f"{tag}: differs from the plain version "
                                 f"(max err {err})")
        for n_shards in (2, 4):
            kl, gl = k // n_shards, groups // n_shards
            for i, part in enumerate(shard(qt, n_shards, 0)):
                got = kmod.qmm_groups(xq[:, i * kl:(i + 1) * kl], part)
                if not torch.equal(got, terms[i * gl:(i + 1) * gl]):
                    raise AssertionError(f"{tag}: shard {i} of {n_shards} "
                                         "differs from its slice of the terms")
        folded = kmod.qmm_groups_fold(terms, xs)
        if not torch.equal(folded, kmod.qmm(xq, qt, xs)):
            raise AssertionError(f"{tag}: the fold differs from the qmm kernel")
        if not torch.equal(folded, ref.fold_group_terms(terms, xs.reshape(-1, 1))):
            raise AssertionError(f"{tag}: the fold differs from its plain version")
        xg = ((xq.float() * xs[:, None]).to(torch.bfloat16)
              .reshape(m, groups, gs).transpose(0, 1).contiguous())
        wg = qt.dequantize(torch.bfloat16).reshape(groups, gs, n)
        nbytes = qt.data.numel() + qt.scale.numel() * 4 + m * k + groups * m * n * 4
        b_ms, b_by = bound_ms(nbytes, 2.0 * m * k * n, INT8_OPS)
        row = {"kernel": "qmm_groups", "shape": f"{name} {k}x{n} W{bits} G={groups} M={m}",
               "bits": bits, "m": m, "max_abs_err": 0.0,
               "ms": timer(lambda: kmod.qmm_groups(xq, qt)),
               "plain_ms": timer(lambda: ref.qmm_group_products(xq, qt)),
               "library_ms": timer(lambda: torch.bmm(xg, wg)),
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(json.dumps(row))
        if m in (1, 4) and bits in (8, 4) and "shard" not in name:
            nbytes = groups * m * n * 4 + m * 4 + m * n * 4
            b_ms, b_by = bound_ms(nbytes, float(groups * m * n), FP32_FLOPS)
            row = {"kernel": "qmm_groups_fold",
                   "shape": f"{name} G={groups} M={m} N={n}", "m": m,
                   "max_abs_err": 0.0,
                   "ms": timer(lambda: kmod.qmm_groups_fold(terms, xs)),
                   "plain_ms": timer(lambda: ref.fold_group_terms(
                       terms, xs.reshape(-1, 1))),
                   "library_ms": timer(lambda: torch.sum(terms, 0)),
                   "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            log(json.dumps(row))
        del w, qt, terms, want, xg, wg


# (name, K, N, group size): olmoe's expert projections, and a ragged
# shape whose rows, groups and scales miss 16-byte alignment (the
# kernel's byte-wise staging)
GROUPED_SHAPES = [("w_up/w_gate", 2048, 1024, 128), ("w_down", 1024, 2048, 128),
                  ("ragged", 960, 1001, 120)]
# decode/prefill capacity; ragged; report batch; a 512-token prefill at
# capacity factor 1.25 (512 * 1.25 * top-8 / 64 experts), two 64-row tiles
GROUPED_CAPS = (1, 5, 20, 80)
N_EXPERTS = 64


def _grouped_counts(gen, s: int, c: int) -> torch.Tensor:
    """Ragged per-segment row counts with empty segments: at C = 1 the 32
    of 64 experts that 4 decode slots x top-8 can reach at most; else
    0..C with every fourth segment empty."""
    if c == 1:
        cnt = torch.zeros(s, dtype=torch.int32, device="cuda")
        cnt[torch.randperm(s, generator=gen, device="cuda")[:32]] = 1
        return cnt
    cnt = torch.randint(0, c + 1, (s,), generator=gen, device="cuda",
                        dtype=torch.int32)
    cnt[::4] = 0
    return cnt


def check_grouped_qmm(timer, gen, rows):
    from repro_torch.kernels import grouped_qmm as kmod, qmm as kqmm, ref
    from repro_torch.qtensor import expert_slice, quantize_experts

    s = N_EXPERTS
    for name, k, n, gsize in GROUPED_SHAPES:
        w = torch.randn((s, k, n), generator=gen, device="cuda") / k ** 0.5
        for bits in (8, 6, 4, 3):
            qt = quantize_experts(w, bits, group_size=gsize)
            wd = qt.dequantize(torch.bfloat16)
            for c in GROUPED_CAPS:
                xq = torch.randint(-127, 128, (s, c, k), generator=gen,
                                   device="cuda", dtype=torch.int32).to(torch.int8)
                xs = torch.rand((s, c, 1), generator=gen, device="cuda") * 0.02 + 1e-3
                cnt = _grouped_counts(gen, s, c)
                ids = torch.randperm(s, generator=gen, device="cuda").to(torch.int32)
                y, dots = kmod.grouped_qmm(xq, qt, xs, cnt, ids, return_dots=True)
                want_dots = ref.grouped_qmm_group_dots(xq, qt, ids)
                want = ref.grouped_qmm(xq, qt, xs, cnt, ids)
                torch.cuda.synchronize()
                tag = f"grouped_qmm {name} W{bits} C={c}"
                valid = torch.arange(c, device="cuda")[None, :] < cnt[:, None]
                vd = valid[:, None, :, None].expand_as(dots)
                if not torch.equal(dots[vd], want_dots[vd]):
                    raise AssertionError(f"{tag}: int32 group dots differ from "
                                         "the plain version")
                if bool((y[~valid] != 0).any()):
                    raise AssertionError(f"{tag}: a row past its count is not 0.0")
                scale = want.abs().max().item()
                err = (y - want).abs().max().item()
                if not torch.allclose(y, want, rtol=1e-5, atol=1e-5 * scale):
                    raise AssertionError(f"{tag}: max err {err} (max|y| {scale})")
                cnt_h, ids_h = cnt.tolist(), ids.tolist()
                for si in range(s):          # the per-expert qmm kernel loop
                    if cnt_h[si]:
                        loop = kqmm.qmm(xq[si], expert_slice(qt, ids_h[si]),
                                        xs[si, :, 0])[:cnt_h[si]]
                        if not torch.equal(y[si, :cnt_h[si]], loop):
                            raise AssertionError(f"{tag}: segment {si} differs "
                                                 "from the qmm kernel")
                active = [si for si in range(s) if cnt_h[si]]
                wsel = wd[ids[active].long()].contiguous()        # (A, K, N)
                xb = (xq[active].float() * xs[active]).to(torch.bfloat16)
                groups = k // gsize
                nbytes = (len(active) * (qt.data[0].numel() + groups * n * 4)
                          + s * c * k + s * c * 4 + s * c * n * 4 + 2 * s * 4)
                b_ms, b_by = bound_ms(nbytes, 2.0 * sum(cnt_h) * k * n, INT8_OPS)
                row = {"kernel": "grouped_qmm",
                       "shape": f"{name} {k}x{n} W{bits} C={c}", "bits": bits,
                       "c": c, "active_experts": len(active),
                       "rows": sum(cnt_h), "max_abs_err": err,
                       "ms": timer(lambda: kmod.grouped_qmm(xq, qt, xs, cnt, ids)),
                       "plain_ms": timer(lambda: ref.grouped_qmm(xq, qt, xs, cnt, ids)),
                       "library_ms": timer(lambda: torch.bmm(xb, wsel)),
                       "bound_ms": b_ms, "bound_by": b_by}
                rows.append(row)
                log(json.dumps(row))
                del xq, xs, y, dots, want_dots, want, wsel, xb
            del qt, wd
        del w


# (name, K, N, activation rows M); the head, the attention and MLP
# projections of internlm2_1_8b, a ragged shape, and the largest K whose
# int32 accumulation is proven not to wrap (127 * 127 * K < 2^31)
INT8_SHAPES = [("wq/wo", 2048, 2048, (1, 4)), ("wk/wv", 2048, 1024, (4,)),
               ("w_up/w_gate", 2048, 8192, (4,)), ("w_down", 8192, 2048, (4,)),
               ("head", 2048, 92544, (4,)), ("ragged", 2056, 1000, (3,)),
               ("full-K limit", 133_144, 256, (1,))]


def count_call(fn, counters) -> tuple:
    """Run ``fn`` once on the card: (its result, the launches each counter
    in ``counters`` (zero-argument callables) rose by, the allocations it
    made and their bytes)."""
    torch.cuda.synchronize()
    before, st0 = [c() for c in counters], torch.cuda.memory_stats()
    y = fn()
    torch.cuda.synchronize()
    after, st1 = [c() for c in counters], torch.cuda.memory_stats()
    allocs = st1["allocation.all.allocated"] - st0["allocation.all.allocated"]
    nbytes = (st1["allocated_bytes.all.allocated"]
              - st0["allocated_bytes.all.allocated"])
    return y, tuple(a - b for a, b in zip(after, before)), allocs, nbytes


def check_int8_one_launch(kmod, xq, w, xs, ws) -> dict:
    """One serving-path int8_matmul call, as ``DequantContext`` makes it
    (``ops.int8_matmul`` with (M, 1) row scales and (1, N) weight scales):
    one launch of the kernel and one allocation, its (M, N) fp32 output —
    no int32 scratch, no epilogue launch, no cast."""
    from repro_torch.kernels import ops

    y, launched, allocs, nbytes = count_call(
        lambda: ops.int8_matmul(xq, w, xs.reshape(-1, 1), ws.reshape(1, -1)),
        [lambda: kmod.launches])
    if launched != (1,) or allocs != 1 or nbytes < y.numel() * 4 \
            or nbytes >= y.numel() * 4 + 512 * 1024:
        raise AssertionError(f"int8_matmul serving call: {launched[0]} "
                             f"launches, {allocs} allocations of {nbytes} B "
                             f"for a {tuple(y.shape)} fp32 output")
    return {"launches": launched[0], "allocations": allocs,
            "allocated_bytes": nbytes}


def check_int8_matmul(timer, gen, rows):
    """The W8A8 kernel against its plain version: outputs ``torch.equal``
    (integer accumulation, the same fp32 epilogue in the same order).
    The full-K row uses the extreme grid values (-127 everywhere), the
    accumulator's worst case; a scalar x_scale is checked on wq; K one
    past the proven limit must be refused before any launch."""
    from repro_torch.kernels import int8_matmul as kmod, ref

    def check(tag, xq, w, xs, ws):
        got = kmod.int8_matmul(xq, w, xs, ws)
        want = ref.int8_matmul(xq, w, torch.as_tensor(xs, device="cuda")
                               .reshape(-1, 1).expand(xq.shape[0], 1),
                               ws.reshape(1, -1))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = (got - want).abs().max().item()
            raise AssertionError(f"int8_matmul {tag}: differs from the plain "
                                 f"version (max err {err})")
        return (got - want).abs().max().item()

    for name, k, n, ms in INT8_SHAPES:
        if name == "full-K limit":
            w = torch.full((k, n), -127, dtype=torch.int8, device="cuda")
        else:
            w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                              dtype=torch.int32).to(torch.int8)
        ws = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-4
        wd = (w.float() * ws).to(torch.bfloat16)
        for m in ms:
            if name == "full-K limit":
                xq = torch.full((m, k), -127, dtype=torch.int8, device="cuda")
            else:
                xq = torch.randint(-127, 128, (m, k), generator=gen,
                                   device="cuda", dtype=torch.int32).to(torch.int8)
            xs = torch.rand(m, generator=gen, device="cuda") * 0.02 + 1e-3
            err = check(f"{name} M={m}", xq, w, xs, ws)
            if name == "wq/wo" and m == 4:
                check(f"{name} M={m} scalar x_scale", xq, w, 0.0123, ws)
                one = check_int8_one_launch(kmod, xq, w, xs, ws)
            nbytes = k * n + m * k + 4 * (m + n + m * n)
            b_ms, b_by = bound_ms(nbytes, 2.0 * m * k * n, INT8_OPS)
            xb = (xq.float() * xs[:, None]).to(torch.bfloat16)
            int_mm_ms = None
            if k % 8 == 0 and n % 8 == 0:      # torch._int_mm's constraints
                xp = torch.zeros((32, k), dtype=torch.int8, device="cuda")
                xp[:m] = xq
                int_mm_ms = timer(lambda: torch._int_mm(xp, w))
            row = {"kernel": "int8_matmul", "shape": f"{name} {k}x{n} M={m}",
                   "m": m, "max_abs_err": err,
                   "ms": timer(lambda: kmod.int8_matmul(xq, w, xs, ws)),
                   "plain_ms": timer(lambda: ref.int8_matmul(
                       xq, w, xs.reshape(-1, 1), ws.reshape(1, -1))),
                   "library_ms": int_mm_ms,
                   "library_bf16_ms": timer(lambda: torch.matmul(xb, wd)),
                   "bound_ms": b_ms, "bound_by": b_by}
            if name == "wq/wo" and m == 4:
                row["one_launch"] = one
            rows.append(row)
            log(json.dumps(row))
        del w, wd
    # one past the proven limit: refused before any launch
    before = kmod.launches
    x = torch.zeros((1, 133_145), dtype=torch.int8, device="cuda")
    w = torch.zeros((133_145, 1), dtype=torch.int8, device="cuda")
    one = torch.ones(1, device="cuda")
    try:
        kmod.int8_matmul(x, w, one, one)
    except ValueError as exc:
        log(f"int8_matmul K=133145 refused: {exc}")
    else:
        raise AssertionError("int8_matmul accepted K=133145")
    if kmod.launches != before:
        raise AssertionError("int8_matmul launched on a refused K")


def _random_pages(gen, bits, p, page, kvh, dh):
    from repro_torch.qtensor import pack, packed_size, qmax_for_bits

    if bits >= 16:
        mk = lambda: torch.randn((p, page, kvh, dh), generator=gen,  # noqa: E731
                                 device="cuda").to(torch.bfloat16)
        return mk(), mk(), None, None
    qm = int(qmax_for_bits(bits))

    def mk():
        q = torch.randint(-qm, qm + 1, (p, page, kvh, dh), generator=gen,
                          device="cuda", dtype=torch.int32).to(torch.int8)
        d = pack(q, bits, axis=-1)
        assert d.shape[-1] == packed_size(dh, bits)
        return d

    sc = lambda: (torch.rand((p, kvh), generator=gen, device="cuda")  # noqa: E731
                  * 0.05 + 0.01)
    return mk(), mk(), sc(), sc()


def check_paged_one_launch(kmod, q, kp, vp, table, lengths, ks, vs,
                           bits) -> dict:
    """One serving-path paged_attention call, as the model makes it
    (``ops.paged_attention`` with (B, 1, H, Dh) queries, an int32 table
    and int64 positions): one launch of the kernel and one allocation, the
    output, plus the partials' scratch where the plan splits a context —
    no cast of the table or lengths, no ``pos + 1``, no scale tensor."""
    from repro_torch.kernels import ops

    b, kvh, g, dh = q.shape
    q1 = q.reshape(b, 1, kvh * g, dh)
    pos = lengths.long() - 1
    plan = kmod.launch_plan(table.shape[1], kp.shape[1], dh, g,
                            kmod.kv_mode(kp.dtype, bits))
    y, launched, allocs, nbytes = count_call(
        lambda: ops.paged_attention(q1, kp, vp, table, pos, ks, vs, bits),
        [lambda: kmod.launches])
    scratch = 4 * b * kvh * plan.ctas * g * (2 + dh) if plan.ctas > 1 else 0
    want = y.numel() * y.element_size() + scratch
    if launched != (1,) or allocs != 1 + (plan.ctas > 1) or nbytes < want \
            or nbytes >= want + 512 * 1024:
        raise AssertionError(f"paged_attention serving call: {launched[0]} "
                             f"launches, {allocs} allocations of {nbytes} B "
                             f"for a {tuple(y.shape)} output and {scratch} B "
                             f"of partials ({plan.ctas} CTAs a slot and head)")
    if not torch.equal(y, kmod.paged_attention(q, kp, vp, table, lengths, ks,
                                               vs, bits)):
        raise AssertionError("paged_attention: ops.paged_attention(pos) "
                             "differs from paged_attention(pos + 1)")
    return {"launches": launched[0], "allocations": allocs,
            "allocated_bytes": nbytes, "ctas_per_slot_head": plan.ctas}


def check_paged_contracts(kmod, got, q, kp, vp, table, lengths, ks, vs,
                          bits) -> None:
    """The kernel's own bit-for-bit contracts: each slot of the batched
    call equals the slot called alone (the split of a slot's pages does
    not depend on B), and the first KV/2 heads, as their own contiguous
    pools and scales, equal those heads of the full call (a kv-head
    shard under tensor parallelism)."""
    b, kvh = q.shape[:2]
    for i in range(b):
        one = kmod.paged_attention(q[i:i + 1], kp, vp, table[i:i + 1],
                                   lengths[i:i + 1], ks, vs, bits)
        if not torch.equal(one, got[i:i + 1]):
            raise AssertionError(f"paged_attention W{bits}: slot {i} alone "
                                 "differs from the batched call")
    hs = kvh // 2
    sub = (lambda t: None if t is None  # noqa: E731
           else t[:, :hs].contiguous() if t.ndim == 2
           else t[:, :, :hs].contiguous())
    shard = kmod.paged_attention(q[:, :hs].contiguous(), sub(kp), sub(vp),
                                 table, lengths, sub(ks), sub(vs), bits)
    if not torch.equal(shard, got[:, :hs]):
        raise AssertionError(f"paged_attention W{bits}: the first {hs} heads "
                             "as their own pools differ from the full call")


def check_paged_attention(timer, gen, rows, b=4, kvh=8, g=2, dh=128, page=16,
                          max_len=256, lengths=(1, 37, 130, 256),
                          widths=(16, 8, 6, 4, 3)):
    """paged_attention against its plain version at every KV width, its
    one-launch serving call and its alone == batched and shard == full
    contracts; ``max_len`` 4096 is the long-context row, whose slots span
    several CTAs (the cross-CTA fold)."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as kmod, ref
    from repro_torch.qtensor import unpack

    np_ = max_len // page
    p = b * np_
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    perm = torch.randperm(p, generator=gen, device="cuda").to(torch.int32)
    table = perm.reshape(b, np_).clone()
    for i, ln in enumerate(lengths.tolist()):
        used = -(-ln // page)
        table[i, used:] = p + i          # unmapped tail (ids >= P)
    q = torch.randn((b, kvh, g, dh), generator=gen, device="cuda").to(torch.bfloat16)
    long_ctx = max_len != 256
    for bits in widths:
        kp, vp, ks, vs = _random_pages(gen, bits, p, page, kvh, dh)
        got = kmod.paged_attention(q, kp, vp, table, lengths, ks, vs, bits)
        # the plain version on the same values in fp32: the kernel's bf16
        # output then differs by its own rounding (half a bf16 ulp, 2^-9
        # relative) plus fp32 summation order; tolerance 2e-3 absolute
        # plus one bf16 ulp (2^-8) relative
        f32 = (lambda t: t.float()) if bits >= 16 else (lambda t: t)  # noqa: E731
        want = ref.paged_attention(q.float().reshape(b, 1, kvh * g, dh),
                                   f32(kp), f32(vp), table, lengths.long() - 1,
                                   ks, vs, bits)
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        err = diff.max().item()
        if not bool((diff <= 2e-3 + 2.0 ** -8 * want.abs()).all()):
            raise AssertionError(f"paged_attention W{bits}: max err {err}")
        check_paged_contracts(kmod, got, q, kp, vp, table, lengths, ks, vs, bits)
        one = (check_paged_one_launch(kmod, q, kp, vp, table, lengths, ks, vs,
                                      bits) if bits in (16, 8) else None)
        # the one library call: SDPA over the gathered, dequantized pages
        ids = table.clamp(0, p - 1).long()
        kg, vg = kp[ids], vp[ids]
        if bits < 16:
            kg = unpack(kg, bits).float() * ks[ids][:, :, None, :, None]
            vg = unpack(vg, bits).float() * vs[ids][:, :, None, :, None]
        kd = kg.reshape(b, max_len, kvh, dh).to(torch.bfloat16)
        vd = vg.reshape(b, max_len, kvh, dh).to(torch.bfloat16)
        del kg, vg
        kd = kd.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        vd = vd.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        qd = q.reshape(b, kvh * g, 1, dh)
        mask = (torch.arange(max_len, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        valid_pages = sum(-(-ln // page) for ln in lengths.tolist())
        tokens = int(lengths.sum().item())
        elem = kp.element_size() * kp.shape[-1]
        nbytes = (q.numel() * 2 * 2 + 2 * valid_pages * page * kvh * elem
                  + (2 * valid_pages * kvh * 4 if bits < 16 else 0)
                  + b * (np_ + 1) * 4)
        b_ms, b_by = bound_ms(nbytes, 4.0 * kvh * g * dh * tokens, FP32_FLOPS)
        row = {"kernel": "paged_attention",
               "shape": (f"B={b} KV={kvh} G={g} Dh={dh} page={page}"
                         + (f" NP={np_} lengths={lengths.tolist()}"
                            if long_ctx else "") + f" W{bits}"),
               "bits": bits, "max_abs_err": err,
               "ms": timer(lambda: kmod.paged_attention(q, kp, vp, table,
                                                        lengths, ks, vs, bits)),
               "plain_ms": timer(lambda: ref.paged_attention(
                   q.reshape(b, 1, kvh * g, dh), kp, vp, table,
                   lengths.long() - 1, ks, vs, bits)),
               "library_ms": timer(lambda: F.scaled_dot_product_attention(
                   qd, kd, vd, attn_mask=mask)),
               "bound_ms": b_ms, "bound_by": b_by}
        if one is not None:
            row["one_launch"] = one
        rows.append(row)
        log(json.dumps(row))
        del kp, vp, kd, vd


BF16_FLOPS = 989e12            # tensor cores, dense; fp16 the same

# (name, shape); ragged sizes, a 3-D shape whose middle axis has a short
# inner stride (the per-channel element walk), internlm2_1_8b's square
# attention weight, an MLP block, the embedding and an activation
FQ_SHAPES = [("ragged 7", (7,)), ("ragged 300x257", (300, 257)),
             ("middle 64x96x12", (64, 96, 12)),
             ("wq 2048x2048", (2048, 2048)), ("w_up 2048x8192", (2048, 8192)),
             ("embed 92544x2048", (92544, 2048)),
             ("act 4x512x2048", (4, 512, 2048))]
FQ_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
FQ_SMALL = ("ragged 7", "ragged 300x257", "middle 64x96x12", "wq 2048x2048")


def _fq_library(x, s, zp, axis, lv):
    """torch.fake_quantize_per_{tensor,channel}_affine on the same grid
    (integer zero points; timed only, the port never calls it)."""
    if axis is None:
        return lambda: torch.fake_quantize_per_tensor_affine(
            x, s.reshape(()), zp.reshape(()).to(torch.int32), 0, int(lv))
    s1, z1 = s.reshape(-1).contiguous(), zp.reshape(-1).to(torch.int32)
    ax = axis % x.ndim
    return lambda: torch.fake_quantize_per_channel_affine(
        x, s1, z1, ax, 0, int(lv))


def check_fake_quant(timer, gen, rows):
    """Both fake-quant kernels against the plain version: ``torch.equal``
    at every dtype (fp32/bf16/fp16), width (8/4/3 bits), grid (affine and
    symmetric ``levels``) and granularity (per tensor; per channel along
    the last axis, along axis 0 and, on the 3-D shape, along the middle
    axis: every route of ``launch_plan``) on the small and ragged shapes;
    at the MLP block and the embedding, bf16 W4 per tensor and W8
    symmetric per channel on both axes, and at an activation-shaped
    (4, 512, 2048) on the last and middle axes, timed (the small shapes'
    bf16 W8 symmetric rows too)."""
    from repro_torch.kernels import fake_quant as kmod, ref
    from repro_torch.quant.quantizer import QuantSpec, quant_params

    n_checked = 0
    routes = set()
    for name, shape in FQ_SHAPES:
        x32 = torch.randn(shape, generator=gen, device="cuda") * 0.05
        axes = (None, -1, 0, 1) if len(shape) > 2 else (None, -1, 0)
        if name in FQ_SMALL:
            grid = [(dt, b, sym, ax) for dt in FQ_DTYPES for b in (8, 4, 3)
                    for sym in (False, True) for ax in axes]
        elif len(shape) > 2:
            grid = [(torch.bfloat16, 8, True, -1), (torch.bfloat16, 8, True, 1)]
        else:
            grid = [(torch.bfloat16, 4, False, None),
                    (torch.bfloat16, 8, True, -1), (torch.bfloat16, 8, True, 0)]
        for dt, bits, sym, ax in grid:
            if ax is not None and x32.ndim < 2:
                continue
            x = x32.to(dt)
            spec = QuantSpec(bits=bits, symmetric=sym, channel_axis=ax)
            s, zp = quant_params(x.float(), spec)
            if ax is not None:
                bshape = [1] * x.ndim
                bshape[ax % x.ndim] = -1
                s, zp = s.reshape(bshape), zp.reshape(bshape)
            lv = float(spec.levels)
            got = kmod.fake_quant(x, s, zp, bits, lv)
            want = ref.fake_quant(x, s, zp, bits, lv)
            torch.cuda.synchronize()
            tag = (f"fake_quant {name} {str(dt)[6:]} W{bits} "
                   f"{'sym' if sym else 'affine'} axis={ax}")
            if not torch.equal(got, want):
                err = (got.float() - want.float()).abs().max().item()
                raise AssertionError(f"{tag}: differs from the plain version "
                                     f"(max err {err})")
            n_checked += 1
            route = None
            if ax is not None:
                route = kmod.launch_plan(x.shape, ax, dt).route
                routes.add(route)
            if name in FQ_SMALL and not (dt == torch.bfloat16 and bits == 8
                                          and sym):
                continue
            kname = "fake_quant" if ax is None else "fake_quant_per_channel"
            nbytes = 2 * x.numel() * x.element_size() + 8 * s.numel()
            b_ms, b_by = bound_ms(nbytes, 6.0 * x.numel(), FP32_FLOPS)
            row = {"kernel": kname,
                   "shape": f"{name} {str(dt)[6:]} W{bits} "
                            f"{'sym' if sym else 'affine'}"
                            + ("" if ax is None else f" axis={ax}"),
                   "route": route, "max_abs_err": 0.0,
                   "ms": timer(lambda: kmod.fake_quant(x, s, zp, bits, lv)),
                   "plain_ms": timer(lambda: ref.fake_quant(x, s, zp, bits, lv)),
                   "library_ms": timer(_fq_library(x, s, zp, ax, lv)),
                   "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            log(json.dumps(row))
        del x32
    if routes != {kmod.ROUTE_WALK, kmod.ROUTE_ROWS, kmod.ROUTE_RUNS}:
        raise AssertionError(f"fake_quant_per_channel: routes {routes} checked")
    log(f"fake_quant: {n_checked} shapes/dtypes/grids equal to the plain version")


# (name, B, H, S, T, D, dtype, causal): the model's prefill shapes at 2048
# and 4096 tokens, cross attention, causal S < T (bottom-right), ragged
# S and T, fp32 at D=32 and fp16 at D=64; then the head dims of the other
# configurations: phi3's prefill at D=96 (its own width), zamba2's D=112
# (width 128, columns past D filled by the TMA), the smoke configs' D=12
# (copied zero-padded to width 32) and D=16, D=256 (64-key tiles), fp32
# at D=96 and at D=12; then head dims past 256 at D=320 and 512 in each
# dtype (bf16/fp16: the split-head-dim wgmma kernel; fp32: the wide
# CUDA-core kernel, 128-column slabs of O), prefill-sized causal rows at
# D=320 and 512, D=300 (copied zero-padded to width 320), D=296 (read in
# place, the TMA filling columns 296..319), D=384 and 448 (the split
# kernel's other two widths) and D=576 (bf16 past 512: the wide CUDA-core
# kernel); fp32 at S=T=1024 H=16 (grids large enough for
# its kernel to form S once over all columns) and at D=301 (4-byte
# copies)
FLASH_CASES = [
    ("causal S=T=2048", 4, 16, 2048, 2048, 128, torch.bfloat16, True),
    ("causal S=T=4096", 4, 16, 4096, 4096, 128, torch.bfloat16, True),
    ("full S=256 T=2048", 4, 16, 256, 2048, 128, torch.bfloat16, False),
    ("causal S=512 T=2048", 4, 16, 512, 2048, 128, torch.bfloat16, True),
    ("causal ragged S=T=300", 2, 16, 300, 300, 128, torch.bfloat16, True),
    ("full ragged S=77 T=300", 2, 16, 77, 300, 128, torch.bfloat16, False),
    ("causal fp32 D=32", 2, 4, 256, 256, 32, torch.float32, True),
    ("full fp16 D=64 S=100 T=384", 2, 8, 100, 384, 64, torch.float16, False),
    ("causal S=T=2048 phi3 D=96", 2, 32, 2048, 2048, 96, torch.bfloat16, True),
    ("causal S=T=1024 zamba2 D=112", 2, 32, 1024, 1024, 112, torch.bfloat16,
     True),
    ("causal ragged S=T=77 D=12", 2, 4, 77, 77, 12, torch.bfloat16, True),
    ("full D=16 S=100 T=300", 2, 4, 100, 300, 16, torch.bfloat16, False),
    ("full fp16 D=256 S=128 T=512", 2, 8, 128, 512, 256, torch.float16, False),
    ("causal fp32 D=96", 2, 8, 256, 256, 96, torch.float32, True),
    ("causal fp32 ragged D=12 S=T=77", 2, 4, 77, 77, 12, torch.float32, True),
    ("causal S=T=256 D=320", 2, 8, 256, 256, 320, torch.bfloat16, True),
    ("full fp16 D=320 S=100 T=300", 2, 4, 100, 300, 320, torch.float16, False),
    ("causal fp32 D=320 S=T=256", 2, 4, 256, 256, 320, torch.float32, True),
    ("causal ragged S=77 T=200 D=512", 2, 4, 77, 200, 512, torch.bfloat16,
     True),
    ("full fp16 D=512 S=128 T=512", 2, 8, 128, 512, 512, torch.float16, False),
    ("causal fp32 D=512 S=T=256", 2, 4, 256, 256, 512, torch.float32, True),
    ("causal S=T=2048 D=320", 2, 16, 2048, 2048, 320, torch.bfloat16, True),
    ("causal S=T=2048 D=512", 2, 16, 2048, 2048, 512, torch.bfloat16, True),
    ("causal S=T=256 padded D=300", 2, 8, 256, 256, 300, torch.bfloat16, True),
    ("causal S=T=256 in place D=296", 2, 8, 256, 256, 296, torch.bfloat16, True),
    ("full fp16 D=384 S=128 T=512", 2, 8, 128, 512, 384, torch.float16, False),
    ("causal ragged S=T=200 D=448", 2, 4, 200, 200, 448, torch.bfloat16, True),
    ("causal S=T=256 D=576", 2, 8, 256, 256, 576, torch.bfloat16, True),
    ("causal fp32 D=320 S=T=1024", 2, 16, 1024, 1024, 320, torch.float32, True),
    ("causal fp32 D=512 S=T=1024", 2, 16, 1024, 1024, 512, torch.float32, True),
    ("full fp32 ragged D=301 S=100 T=300", 2, 4, 100, 300, 301, torch.float32,
     False),
]
# the kernel each head dim and dtype must take past 256
WIDE_KERNEL = {(torch.bfloat16, 320): "split", (torch.float16, 320): "split",
               (torch.bfloat16, 512): "split", (torch.float16, 512): "split",
               (torch.bfloat16, 300): "split", (torch.bfloat16, 296): "split",
               (torch.float16, 384): "split", (torch.bfloat16, 448): "split",
               (torch.bfloat16, 576): "wide", (torch.float32, 320): "f32_wide",
               (torch.float32, 512): "f32_wide", (torch.float32, 301): "f32_wide"}


def flash_pairs(s: int, t: int, causal: bool) -> int:
    """Visible (query, key) pairs: with the causal mask aligned
    bottom-right, query i sees keys j <= i + t - s."""
    if not causal:
        return s * t
    return s * (s + 1) // 2 + s * (t - s)


def check_flash_attention(timer, gen, rows):
    """The flash kernel against the plain version on the same inputs,
    element by element: |diff| <= rel·(A + |ref|) + 1e-6, with A = Σ_j
    p_j·|v_j| (the plain version on |v| in fp32), the scale of the terms
    each output sums. bf16/fp16: rel = 2^-7. Each version rounds every P
    term to the input dtype (2^-9 relative; the kernel unnormalized
    against its running max, the plain version after the softmax) and
    its output (2^-9), so they may differ by 2^-8·(A + |ref|): the bound
    is twice that. fp32: rel = 1e-5 (no rounding of P; exp and the sums
    in other orders)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kmod, ref

    for name, b, h, s, t, d, dt, causal in FLASH_CASES:
        mk = lambda n: torch.randn((b, h, n, d), generator=gen,  # noqa: E731
                                   device="cuda").to(dt)
        q, k, v = mk(s), mk(t), mk(t)
        kernel = kmod.kernel_for(kmod.width_plan(d, dt)[0], dt)
        if d > 256 and WIDE_KERNEL[(dt, d)] != kernel:
            raise AssertionError(f"flash_attention {name}: planned for the "
                                 f"{kernel} kernel, not {WIDE_KERNEL[(dt, d)]}")
        before = dict(kmod.launches_by_kernel)
        got = kmod.flash_attention(q, k, v, causal=causal)
        ran = {n: c - before[n] for n, c in kmod.launches_by_kernel.items()}
        if ran != {n: int(n == kernel) for n in ran}:
            raise AssertionError(f"flash_attention {name}: launched {ran}, "
                                 f"not one {kernel}")
        want = ref.flash_attention(q, k, v, causal=causal).float()
        mag = ref.flash_attention(q.float(), k.float(), v.float().abs(),
                                  causal=causal)
        torch.cuda.synchronize()
        diff = (got.float() - want).abs()
        err = diff.max().item()
        rel = 1e-5 if dt == torch.float32 else 2.0 ** -7
        ratio = (diff / (rel * (mag + want.abs()) + 1e-6)).max().item()
        del mag
        if not (torch.isfinite(got).all() and ratio <= 1.0):
            raise AssertionError(f"flash_attention {name}: max err {err}, "
                                 f"{ratio:.3f} of the tolerance")
        nbytes = (2 * s + 2 * t) * b * h * d * q.element_size()
        peak = FP32_FLOPS if dt == torch.float32 else BF16_FLOPS
        b_ms, b_by = bound_ms(nbytes, 4.0 * b * h * d * flash_pairs(s, t, causal),
                              peak)
        if causal and s != t:          # SDPA's is_causal aligns top-left
            mask = torch.ones((s, t), dtype=torch.bool, device="cuda").tril(t - s)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=causal)
        row = {"kernel": "flash_attention",
               "shape": f"{name} B={b} H={h} D={d} {str(dt)[6:]}",
               "route": kernel, "max_abs_err": err, "tolerance_share": ratio,
               "ms": timer(lambda: kmod.flash_attention(q, k, v, causal=causal)),
               "plain_ms": timer(lambda: ref.flash_attention(q, k, v, causal=causal)),
               "library_ms": timer(lib),
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(json.dumps(row))
        del q, k, v, got, want, diff
    check_flash_split_one_launch(kmod, gen)
    # causal S > T is refused before any launch
    before = kmod.launches
    q = torch.zeros((1, 1, 65, 32), device="cuda")
    kv = torch.zeros((1, 1, 64, 32), device="cuda")
    try:
        kmod.flash_attention(q, kv, kv, causal=True)
    except ValueError as exc:
        log(f"flash_attention causal S > T refused: {exc}")
    else:
        raise AssertionError("flash_attention accepted causal S > T")
    if kmod.launches != before:
        raise AssertionError("flash_attention launched on a refused shape")


def check_flash_split_one_launch(kmod, gen) -> None:
    """A call on the split-head-dim route is one launch of that kernel: at
    D = 320 and 296 (rows of whole 16-byte chunks) q, k and v are read in
    place, so the output is the call's only allocation; at D = 300 they
    are copied zero-padded to width 320 (three more)."""
    for d, want_allocs in ((320, 1), (296, 1), (300, 4)):
        q, k, v = (torch.randn((2, 8, 256, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        y, launched, allocs, nbytes = count_call(
            lambda: kmod.flash_attention(q, k, v, causal=True),
            [lambda: kmod.launches, lambda: kmod.launches_by_kernel["split"]])
        if launched != (1, 1) or allocs != want_allocs:
            raise AssertionError(f"flash_attention D={d}: {launched} launches "
                                 f"(all, split), {allocs} allocations of "
                                 f"{nbytes} B for a {tuple(y.shape)} output")
        log(f"flash_attention D={d} bf16: one split-kernel launch, {allocs} "
            f"allocation(s), {nbytes} B")


# (kernel, check, keyword arguments), in the order phase 2 runs them
PHASE2 = [("ef_sqnorm", check_ef_sqnorm, {}),
          ("paged_attention", check_paged_attention, {}),
          ("paged_attention", check_paged_attention, {"kvh": 16, "g": 1}),  # olmoe's GQA
          # a long context: slots spanning several CTAs (the cross-CTA fold)
          ("paged_attention", check_paged_attention,
           {"max_len": 4096, "lengths": (1, 1000, 2500, 4096), "widths": (8, 16)}),
          # G = 4 (the kernel's two passes over the query rows) and Dh =
          # 576 (two chunk sets a row: K chunks past the first 32 and a
          # second V pass)
          ("paged_attention", check_paged_attention,
           {"kvh": 4, "g": 4, "widths": (8, 16)}),
          ("paged_attention", check_paged_attention,
           {"kvh": 4, "g": 2, "dh": 576, "widths": (8, 16)}),
          ("qmm", check_qmm, {}),
          ("qmm_groups", check_qmm_groups, {}),
          ("grouped_qmm", check_grouped_qmm, {}),
          ("int8_matmul", check_int8_matmul, {}),
          ("fake_quant", check_fake_quant, {}),
          ("flash_attention", check_flash_attention, {})]


def ptxas_summary(text: str) -> str:
    """The kernel names, registers, spills and shared memory of the last
    build's ``-Xptxas -v`` output, one kernel a line."""
    out, name = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.split('ptxas info    :')[-1].strip()}")
        elif line.startswith("==") or "warning" in line or "error" in line:
            out.append(line)
    return "\n".join(out)


# --------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phase 2)")
    ap.add_argument("--only", default="",
                    help="comma-separated kernels whose phase-2 checks run "
                         "(the others are skipped); implies --kernels-only")
    args = ap.parse_args()
    only = {name for name in args.only.split(",") if name}
    if only - {name for name, _, _ in PHASE2}:
        ap.error(f"--only: unknown kernels {sorted(only - {n for n, _, _ in PHASE2})}")
    args.kernels_only = args.kernels_only or bool(only)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind}")
    log(f"card: {card}")

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    _build.lib()
    log(f"phase 1: built kernels in {time.perf_counter() - t0:.1f} s "
        f"({_build.BUILD_DIR})")
    ptx = sorted(_build.BUILD_DIR.glob("*/ptxas.log"),
                 key=lambda p: p.stat().st_mtime)
    if ptx:
        log(ptxas_summary(ptx[-1].read_text()))

    # ---- phase 2: kernels vs plain versions ----
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = Timer()
    rows: list = []
    t0 = time.perf_counter()
    for name, check, kw in PHASE2:
        if not only or name in only:
            check(timer, gen, rows, **kw)
    log(f"phase 2: {len(rows)} kernel checks passed in "
        f"{time.perf_counter() - t0:.1f} s")
    result = {"card": card, "kind": kind, "kernel_checks": rows}

    if not args.kernels_only:
        result["small_reference_err"] = errs = {
            arch: check_small_reference(arch) for arch in SMOKE_ARCHS}
        log(f"phase 3a: smoke-config decode on the card agrees with the CPU "
            f"plain path (max err {errs})")
        result["main_paths"] = {}
        kept = {}
        for arch, microbatch in MAIN_PATHS:
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            result["main_paths"][arch], kept[arch] = main_path(arch, microbatch)
            # parked on the host while the next path measures its memory
            kept[arch]["qparams"] = tree_to(kept[arch]["qparams"], "cpu")
            mp = result["main_paths"][arch]
            log(f"phase 3b: {arch} main path in {time.perf_counter() - t0:.1f} s, "
                f"peak device memory {mp['peak_mem_gb']:.1f} GB")
            log(json.dumps({"main_path": mp}))
        # phase 3f serves phase 3b's params again, sharded: it runs here so
        # they are freed before the later phases measure their memory
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        result["tp_path"] = tpp = tp_path(kept)
        log(f"phase 3f: tensor-parallel path in {time.perf_counter() - t0:.1f} s")
        log(json.dumps({"tp_path": tpp}))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        result["spec_path"] = spp = spec_path(kept)
        del kept
        log(f"phase 3g: sampled and speculative serving in "
            f"{time.perf_counter() - t0:.1f} s")
        log(json.dumps({"spec_path": spp}))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        result["cli_path"] = cp = cli_path()
        log(f"phase 3c: serving CLI path in {time.perf_counter() - t0:.1f} s, "
            f"peak device memory {cp['peak_mem_gb']:.1f} GB")
        log(json.dumps({"cli_path": cp}))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        result["library_path"] = lp = library_path()
        log(f"phase 3d: quantization library path in "
            f"{time.perf_counter() - t0:.1f} s, peak device memory "
            f"{lp['peak_mem_gb']:.1f} GB")
        log(json.dumps({"library_path": lp}))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        result["train_path"] = tp = train_path()
        log(f"phase 3e: QAT training path in {time.perf_counter() - t0:.1f} s, "
            f"peak device memory {tp['peak_mem_gb']:.1f} GB")
        log(json.dumps({"train_path": tp}))

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    if args.kernels_only:
        return 0
    mps = result["main_paths"]
    paths = ([mp["launches"] for mp in mps.values()]
             + [tpp["launches"], spp["launches"], cp["launches"], lp["launches"],
                tp["launches"]])
    log(json.dumps({"kernels": kernels_line(rows, paths)}))
    for arch, mp in mps.items():
        log(f"[{card}] {arch}: report {mp['report_s']:.2f} s; packed weights "
            f"{mp['packed_bytes'] / 1e9:.3f} GB vs FIT-predicted "
            f"{mp['predicted_bytes'] / 1e9:.3f} GB; decode "
            f"{mp['decode_tokens_per_s']:.1f} tok/s; TTFT p50 "
            f"{mp['ttft_p50']:.3f} s p95 {mp['ttft_p95']:.3f} s; peak "
            f"{mp['peak_mem_gb']:.1f} GB")
    ab = tpp["step_ab"]["median_ms"]
    log(f"[{card}] decode step at batch 4, in turns: plain {ab['plain']:.1f} ms, "
        f"tp=1 mesh {ab['tp=1 mesh']:.1f} ms, tp=2 on one card {ab['tp=2']:.1f} ms")
    log(f"[{card}] plain decode step at batch 4 through the run, ms: " + ", ".join(
        f"{arch} 3b {mp['step_before_profile']['median_ms']['plain']:.1f} before "
        f"/ {mp['step_after_empty_profile']['median_ms']['plain']:.1f} after an "
        f"empty / {mp['step_after_profile']['median_ms']['plain']:.1f} after its "
        "serving profile" for arch, mp in mps.items())
        + f"; 3f start {ab['plain']:.1f}, 3f end "
        f"{tpp['plain_step_after']['median_ms']['plain']:.1f}")
    log(f"[{card}] phase 3f seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in tpp["seconds"].items()))
    for tag, run in tpp["runs"].items():
        log(f"[{card}] tensor-parallel {tag}: {run['shards']} shards on one card; "
            f"per-shard weights {run['shard_weight_bytes'] / 1e9:.3f} GB, pools "
            f"{run['shard_pool_bytes'] / 1e6:.1f} MB; decode "
            f"{run['decode_tokens_per_s']:.1f} tok/s, "
            f"{run['decode_ms_per_step']:.1f} ms/step; peak "
            f"{run['peak_mem_gb']:.1f} GB; device busy "
            + f"{run['profile']['device_busy_share']:.3f}")
    for tag, r in spp["multi_token"].items():
        log(f"[{card}] 3g multi-token decode ({tag}): 5-token call == 5 steps, "
            f"logits {r['logits_equal']}, cache {r['caches_equal']}")
    runs, dp = spp["runs"], spp["draft_plan"]
    turns = {m: [runs[f"{m} paged greedy {i}"]["decode_tokens_per_s"]
                 for i in (1, 2)] for m in ("plain", "spec")}
    log(f"[{card}] 3g internlm2_1_8b decode tok/s in turns (plain, spec, spec, "
        f"plain; 4 requests, greedy, paged): plain {turns['plain'][0]:.1f} / "
        f"{turns['plain'][1]:.1f}, spec k={SPEC_K} {turns['spec'][0]:.1f} / "
        f"{turns['spec'][1]:.1f}")
    for tag, r in runs.items():
        if "spec" in r:
            sp = r["spec"]
            log(f"[{card}] 3g {tag}: accept rate {sp['accept_rate']:.3f} "
                f"({sp['accepted']}/{sp['proposed']}), {sp['dispatches']} "
                f"dispatches, {r['decode_tokens_per_s']:.1f} tok/s")
    log(f"[{card}] 3g draft plan allocate_draft_bits(avg_bits="
        f"{SPEC_DRAFT_AVG_BITS}): realized {dp['avg_bits']:.3f} bits "
        f"{dp['bit_histogram']}, kl_proxy {dp['kl_proxy']:.4g}, accept_proxy "
        f"{dp['accept_proxy']:.4f}")
    sab = spp["sampler_ab"]
    log(f"[{card}] 3g decode step + sampler at batch {sab['batch']}, vocab "
        f"{sab['vocab']}, in turns: greedy {sab['median_ms']['greedy']:.1f} ms, "
        f"full (t 0.8, top-k 50, top-p 0.95) {sab['median_ms']['full']:.1f} ms; "
        f"sampler alone {sab['sampler_ms']['greedy']:.4f} / "
        f"{sab['sampler_ms']['full']:.4f} ms")
    log(f"[{card}] phase 3g seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in spp["seconds"].items()))
    log(f"[{card}] launch.serve internlm2_1_8b --int8 --int8-compute --paged: "
        f"int8-backed weights {cp['weight_bytes'] / 1e9:.3f} GB; decode "
        f"{cp['decode_tokens_per_s']:.1f} tok/s; TTFT p50 {cp['ttft_p50']:.3f} s "
        f"p95 {cp['ttft_p95']:.3f} s; shared {cp['kv_shared_tokens']} tokens, "
        f"{cp['kv_cow_copies']} COW copies; device busy "
        f"{cp['profile']['device_busy_share']:.3f}")
    log(f"[{card}] quantization library internlm2_1_8b: {lp['weight_blocks']} "
        f"weight blocks x 3 specs and {lp['act_sites']} activation sites "
        f"through the STE in {lp['fake_quant_s']:.2f} s; flash attention "
        f"{lp['flash_vs_chunked']['shape']} in {lp['flash_s'] * 1e3:.2f} ms")
    log(f"[{card}] QAT W4A8 training internlm2_1_8b: {tp['s_per_step']:.3f} "
        f"s/step, {tp['tokens_per_s']:.0f} tokens/s, peak "
        f"{tp['peak_mem_gb']:.1f} GB, device busy "
        f"{tp['profile']['device_busy_share']:.3f}, losses "
        + " ".join(f"{v:.4f}" for v in tp["losses"]))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


KERNELS = [
    # name, source, TPU kernel it replaces, representative phase-2 row
    ("ef_sqnorm", "src/repro_torch/kernels/csrc/ef_sqnorm.cu",
     "src/repro/kernels/ef_sqnorm.py:34", "(4, 189530112) bf16"),
    ("qmm", "src/repro_torch/kernels/csrc/qmm.cu",
     "src/repro/kernels/qmm.py:153", "head 2048x92544 W4 M=4"),
    ("qmm_groups", "src/repro_torch/kernels/csrc/qmm.cu",
     "src/repro/kernels/qmm.py:112", "w_down 8192x2048 W4 G=64 M=4"),
    ("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:90",
     "B=4 KV=8 G=2 Dh=128 page=16 W8"),
    ("grouped_qmm", "src/repro_torch/kernels/csrc/grouped_qmm.cu",
     "src/repro/kernels/grouped_qmm.py:125", "w_up/w_gate 2048x1024 W4 C=20"),
    ("int8_matmul", "src/repro_torch/kernels/csrc/int8_matmul.cu",
     "src/repro/kernels/int8_matmul.py:53", "head 2048x92544 M=4"),
    ("fake_quant", "src/repro_torch/kernels/csrc/fake_quant.cu",
     "src/repro/kernels/fake_quant.py:34", "w_up 2048x8192 bfloat16 W4 affine"),
    ("fake_quant_per_channel", "src/repro_torch/kernels/csrc/fake_quant.cu",
     "src/repro/kernels/fake_quant.py:82",
     "w_up 2048x8192 bfloat16 W8 sym axis=0"),
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:68",
     "causal S=T=2048 B=4 H=16 D=128 bfloat16"),
]
SMOKE_ARCHS = ("internlm2_1_8b", "olmoe_1b_7b", "deepseek_moe_16b")
# full-width main paths (arch, report microbatch), driven in this order
MAIN_PATHS = (("internlm2_1_8b", 4), ("olmoe_1b_7b", 2))
# the kernels each main path must launch ("cli": the serving CLI's
# int8-backed path, which must launch none of CLI_IDLE_KERNELS)
PATH_KERNELS = {"dense": ("ef_sqnorm", "qmm", "paged_attention"),
                "moe": ("ef_sqnorm", "qmm", "paged_attention", "grouped_qmm"),
                "cli": ("int8_matmul", "paged_attention"),
                "library": ("fake_quant", "fake_quant_per_channel",
                            "flash_attention"),
                "tp": ("qmm_groups", "qmm", "paged_attention", "grouped_qmm",
                       "int8_matmul"),
                # phase 3g's runs, by path
                "sampled": ("qmm", "paged_attention"),
                "sampled_tp": ("qmm_groups", "qmm", "paged_attention"),
                "spec": ("qmm", "paged_attention"),
                "spec_moe": ("qmm", "paged_attention", "grouped_qmm"),
                "spec_int8": ("int8_matmul", "paged_attention")}
CLI_IDLE_KERNELS = ("qmm", "qmm_groups", "grouped_qmm", "ef_sqnorm")
# each kernel's launch counter: (module under repro_torch.kernels, attribute)
COUNTERS = {"ef_sqnorm": ("ef_sqnorm", "launches"), "qmm": ("qmm", "launches"),
            "qmm_groups": ("qmm", "launches_groups"),
            "qmm_groups_fold": ("qmm", "launches_fold"),
            "paged_attention": ("paged_attention", "launches"),
            "grouped_qmm": ("grouped_qmm", "launches"),
            "int8_matmul": ("int8_matmul", "launches"),
            "fake_quant": ("fake_quant", "launches"),
            "fake_quant_per_channel": ("fake_quant", "launches_per_channel"),
            "flash_attention": ("flash_attention", "launches")}


def _kernel_modules():
    import importlib
    return {mod: importlib.import_module(f"repro_torch.kernels.{mod}")
            for mod, _ in COUNTERS.values()}


def reset_counts() -> None:
    mods = _kernel_modules()
    for mod, attr in COUNTERS.values():
        setattr(mods[mod], attr, 0)


def read_counts() -> dict:
    mods = _kernel_modules()
    return {name: getattr(mods[mod], attr) for name, (mod, attr) in COUNTERS.items()}


def check_small_reference(arch: str) -> float:
    """The packed paged decode path on the card against the same path on
    the CPU (plain versions) at a smoke config: per-step logits agree.
    Tolerance 2e-2 absolute on logits of size ~1: fp32 sums run in
    another order, so a value at a rounding boundary may land one grid
    step apart in an activation's per-row int8 grid or in a 4-bit KV
    page, which moves a logit by a few 1e-3."""
    from repro_torch.configs import smoke_config
    from repro_torch.kvcache.paged import PagedKVConfig
    from repro_torch.models.context import DequantContext
    from repro_torch.models.decode import decode_step, init_paged_decode_state
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.quantized import quantize_params

    cfg = smoke_config(arch)
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, seed=0, device="cpu")
        qp, _ = quantize_params(params, 4, group_size=16, device=dev)
        pc = PagedKVConfig.build(cfg, 32, 2, page_size=8, kv_bits={0: 8, 1: 4})
        st = init_paged_decode_state(cfg, pc, 2, device=dev)
        st.paged.table.copy_(torch.arange(8, dtype=torch.int32).reshape(2, 4))
        st.paged.write_limit.fill_(32)
        ctx = DequantContext(None, cfg.param_dtype, int8_compute=True)
        toks = (torch.arange(2 * 12, dtype=torch.int32).reshape(2, 12) * 7
                % cfg.vocab_size)
        logits = []
        with torch.no_grad():
            for i in range(12):
                lg, st = decode_step(qp, st, toks[:, i:i + 1].to(dev), cfg, ctx)
                logits.append(lg.float().cpu())
        out[dev] = torch.stack(logits)
    err = (out["cpu"] - out["cuda"]).abs().max().item()
    if not (torch.isfinite(out["cuda"]).all() and err <= 2e-2):
        raise AssertionError(f"{arch} smoke decode: card vs CPU max err {err}")
    return err


def main_path(arch: str, microbatch: int):
    """One full-width main path; returns its metrics and what phase 3f
    needs to serve the same requests sharded. Every kernel counter is set
    to 0 at the start and read right after the serving run."""
    from repro_torch.configs import get_config
    from repro_torch.core.report import build_report
    from repro_torch.data.synthetic import LMStreamConfig, lm_batches
    from repro_torch.kvcache.fit import allocate_kv_bits, kv_report_fns
    from repro_torch.kvcache.paged import dense_kv_bytes
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.qtensor import storage_summary
    from repro_torch.quant.policy import QuantPolicy
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.loadgen import poisson_requests
    from repro_torch.serve.quantized import bit_config_from_report, quantize_params

    cfg = get_config(arch)
    res = {"arch": arch, "layers": cfg.num_layers, "microbatch": microbatch}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    stream = lm_batches(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                       global_batch=4, seed=0))
    batches = [next(stream) for _ in range(2)]
    tap_loss, tap_shapes, act_fn = kv_report_fns(cfg)
    t0 = time.perf_counter()
    report = build_report(lambda p, b: loss_fn(p, b, cfg), tap_loss,
                          lambda b: tap_shapes(params, b), act_fn, params,
                          batches, microbatch=microbatch, tolerance=None,
                          max_batches=2)
    torch.cuda.synchronize()
    res["report_s"] = time.perf_counter() - t0
    res["report_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    traces = list(report.weight_traces.values()) + list(report.act_traces.values())
    if not all(math.isfinite(t) and t > 0 for t in traces):
        raise AssertionError("non-finite or non-positive EF trace")
    res["n_weight_blocks"] = len(report.weight_traces)
    res["n_act_sites"] = len(report.act_traces)

    policy = QuantPolicy(allowed_bits=(8, 4))
    bit_cfg = bit_config_from_report(report, policy, avg_bits=6.0)
    t0 = time.perf_counter()
    qparams, _ = quantize_params(params, bit_cfg, policy, group_size=128)
    torch.cuda.synchronize()
    res["quantize_s"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    ws = storage_summary(qparams)
    res["bit_histogram"] = {str(k): v for k, v in ws["bit_histogram"].items()}
    res["packed_bytes"] = ws["packed_bytes"]
    res["predicted_bytes"] = ws["predicted_bytes"]

    ecfg = EngineConfig(max_slots=4, max_len=256, max_new_tokens=32,
                        prefill_chunk=32, page_size=16, kv_cache="paged",
                        int8_compute=True, prefix_sharing=False, clock="wall")
    kv_elems = dense_kv_bytes(cfg, ecfg.max_slots, ecfg.max_len, bits=8)
    kv_bits = allocate_kv_bits(report, cfg, QuantPolicy(), 6.0 / 8.0 * kv_elems,
                               tokens=ecfg.max_slots * ecfg.max_len)
    res["kv_bits"] = {str(k): v for k, v in kv_bits.items()}
    engine = Engine(qparams, cfg, ecfg, kv_bits=kv_bits,
                    kv_ranges=report.act_ranges)

    def requests():
        return poisson_requests(cfg, 8, rate=4.0, prompt_len=(16, 64),
                                gen_len=(8, 32), seed=1)

    t0 = time.perf_counter()
    fin, metrics = engine.run(requests())
    torch.cuda.synchronize()
    res["serve_s"] = time.perf_counter() - t0
    res["launches"] = read_counts()
    if len(fin) != 8:
        raise AssertionError(f"{len(fin)} of 8 requests finished")
    for r in fin:
        if r.num_generated != r.max_new_tokens:
            raise AssertionError(f"request {r.id}: {r.num_generated} of "
                                 f"{r.max_new_tokens} tokens")
        if not ((r.output_tokens >= 0) & (r.output_tokens < cfg.vocab_size)).all():
            raise AssertionError(f"request {r.id}: token out of the vocab")
    for name in PATH_KERNELS[cfg.family]:
        if res["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"{arch} main path")
    if cfg.family == "moe":
        # capacity couples a token to its batch-mates, so alone == batched
        # does not hold for MoE (nor in the reference); its contract is
        # grouped == dense dispatch, bit for bit
        res["grouped_equals_dense"] = check_grouped_equals_dense(
            qparams, cfg, ecfg, kv_bits, report.act_ranges)
    else:
        # one request served alone equals the same request in the batch
        for rid in (0, 5):
            alone = [r for r in requests() if r.id == rid]
            alone[0].arrival_time = 0.0
            got, _ = engine.run(alone)
            if not (got[0].output_tokens == fin[rid].output_tokens).all():
                raise AssertionError(f"request {rid}: alone != batched")
    # the plain decode step around the first profiler sessions of the
    # process, one around no work, then the serving profile, to hold
    # against phase 3f's (``decode_step_ab``)
    res["step_before_profile"] = decode_step_ab({"plain": engine})
    device_kernels(lambda: None)
    res["step_after_empty_profile"] = decode_step_ab({"plain": engine})
    res["profile"] = profile_serving(engine, cfg)
    res["step_after_profile"] = decode_step_ab({"plain": engine})
    s = metrics.summary()
    res.update({k: s[k] for k in ("decode_tokens_per_s", "prefill_tokens_per_s",
                                  "ttft_p50", "ttft_p95", "e2e_p50",
                                  "token_latency_p50_ms", "decode_tokens",
                                  "kv_peak_bytes", "kv_pool_bytes")})
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # what phase 3f serves again, sharded: the same params, KV widths,
    # ranges, engine shape, requests and the plain engine's streams
    keep = {"cfg": cfg, "qparams": qparams, "kv_bits": kv_bits,
            "ranges": report.act_ranges, "ecfg": ecfg, "requests": requests,
            "streams": [r.output_tokens.tolist() for r in fin],
            "report": report}
    return res, keep


TP_INT8_LAYERS = 4      # depth of the int8-backed tp run (full width)


def tree_to(tree, device):
    from repro_torch.utils.pytree import map_with_names
    return map_with_names(lambda _, leaf: leaf.to(device), tree)


def decode_step_ab(engines: dict, turns: int = 2, steps: int = 8) -> dict:
    """Host-clock milliseconds per decode step at batch ``max_slots`` of
    each engine's context on its own weights, timed in turns (the names
    in order, then reversed, ``turns`` times; ``steps`` steps a leg,
    ending in a synchronize) on fresh paged states that map every page;
    the first step's logits of every engine are held ``torch.equal`` to
    the first engine's."""
    from repro_torch.models.decode import decode_step

    first, states, toks = {}, {}, {}
    with torch.no_grad():
        for name, eng in engines.items():
            ec = eng.ecfg
            s, npp = ec.max_slots, ec.max_len // ec.page_size
            toks[name] = torch.zeros((s, 1), dtype=torch.int32, device=eng.device)
            st = eng._fresh_state()
            st.paged.table.copy_(torch.arange(s * npp, dtype=torch.int32)
                                 .reshape(s, npp))
            st.paged.write_limit.fill_(ec.max_len)
            first[name], states[name] = decode_step(eng.params, st, toks[name],
                                                    eng.cfg, ctx=eng._ctx)
        lead = next(iter(engines))
        for name in engines:
            if not torch.equal(first[name], first[lead]):
                raise AssertionError(f"step A/B: {name} logits differ from "
                                     f"{lead}'s")

        def timed(name):
            eng, st = engines[name], states[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                _, st = decode_step(eng.params, st, toks[name], eng.cfg,
                                    ctx=eng._ctx)
            torch.cuda.synchronize()
            states[name] = st
            return 1e3 * (time.perf_counter() - t0) / steps

        order = list(engines) + list(engines)[::-1]
        times = {name: [] for name in engines}
        for name in order * turns:
            times[name].append(timed(name))
    return {"batch": engines[lead].ecfg.max_slots, "steps": steps,
            "ms_per_step": times,
            "median_ms": {k: statistics.median(v) for k, v in times.items()},
            "gc_objects": len(gc.get_objects())}


def tp_path(kept: dict) -> dict:
    """Phase 3f: tensor-parallel serving at full width, one process
    driving every shard (``launch.mesh.TPMesh``) on this one card, so the
    shard-local kernels run at their shard-local shapes and no byte
    crosses cards. Each run's counters are set to 0 just before it and
    read just after; the plain engines it is held against run outside
    those windows.

      * first, the decode-step A/B of ``decode_step_ab`` on phase 3b's
        internlm2_1_8b params: the plain context, the tp=1 mesh's and
        tp=2's in turns, first-step logits ``torch.equal``;
      * internlm2_1_8b, phase 3b's params, KV widths, ranges, engine and
        8 requests, at ``make_tp_mesh(1)`` and at tp=2 (``TPMesh([cuda:0]
        * 2)``: column blocks through qmm at N/2, row blocks through
        qmm_groups at K/2, pools 4 kv heads a shard): greedy streams
        identical to phase 3b's plain engine, token for token;
      * olmoe_1b_7b at tp=2 (32 experts a shard through grouped_qmm):
        identical to its plain engine on 4 requests (step clock: capacity
        couples a token to its batch-mates, so both runs batch alike);
      * the serving CLI's int8-backed params (W8, ``quantize_params_int8``
        of the seeded init) at full width and ``TP_INT8_LAYERS`` layers,
        tp=2 with a shared prefix: int8_matmul on the column blocks;
        identical to the tp=1 plain engine, with the same sharing and
        copy-on-write counts;
      * last, the plain context's decode step again (``decode_step_ab``
        on one engine), to compare with the A/B's plain leg and with
        phase 3b's.

    Every serving run is profiled (``profile_serving``); ``seconds``
    holds each part's wall time. qmm_groups launches must equal
    (row-parallel blocks) x (shards) x (forward calls), its fold
    (row-parallel blocks) x (forward calls)."""
    from repro_torch.configs import get_config
    from repro_torch.kvcache.paged import pool_bytes
    from repro_torch.launch.mesh import TPMesh, make_tp_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.quant.policy import QuantPolicy
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.loadgen import poisson_requests, trace_requests
    from repro_torch.qtensor import is_qtensor
    from repro_torch.serve.quantized import (qw_path, quantize_params_int8,
                                             sharded_storage_bytes)
    from repro_torch.utils.pytree import named_leaves

    card = torch.device("cuda", 0)
    res = {"runs": {}, "launches": {}, "seconds": {}}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        res["seconds"][name] = now - clock[0]
        clock[0] = now

    for k in kept.values():
        k["qparams"] = tree_to(k["qparams"], card)
    lap("params to the card")

    # the host cost of the sharded context, in turns on the same weights
    k = kept["internlm2_1_8b"]
    engines = {name: Engine(k["qparams"], k["cfg"], dataclasses.replace(
        k["ecfg"], mesh=mesh), kv_bits=k["kv_bits"], kv_ranges=k["ranges"])
        for name, mesh in (("plain", None), ("tp=1 mesh", make_tp_mesh(1)),
                           ("tp=2", TPMesh([card] * 2)))}
    res["step_ab"] = decode_step_ab(engines)
    del engines
    lap("decode-step A/B")

    def run(tag, qparams, cfg, ecfg, mesh, reqs, want, **kw):
        engine = Engine(qparams, cfg, dataclasses.replace(ecfg, mesh=mesh), **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        fin, m = engine.run(reqs())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        got = [r.output_tokens.tolist() for r in fin]
        if got != want:
            raise AssertionError(f"tp {tag}: greedy streams differ from the "
                                 f"plain engine's: {got} vs {want}")
        plan = engine._shard_plan
        n = mesh.size
        blocks = {mode: sum(v == mode for v in plan.values())
                  for mode in ("col", "row", "ep")}
        if not blocks["row"]:
            raise AssertionError(f"tp {tag}: no row-parallel block planned")
        # packed row blocks run qmm_groups; int8-backed ones exact int32 sums
        qrow = sum(plan.get(qw_path(name)) == "row" and is_qtensor(leaf)
                   for name, leaf in named_leaves(qparams))
        fwd = m.prefill_tokens + m.decode_steps
        if (launches["qmm_groups"] != qrow * n * fwd
                or launches["qmm_groups_fold"] != qrow * fwd):
            raise AssertionError(
                f"tp {tag}: {launches['qmm_groups']} qmm_groups / "
                f"{launches['qmm_groups_fold']} fold launches for {qrow} "
                f"packed row blocks x {n} shards x {fwd} forward calls")
        s = m.summary()
        out = {"shards": n, "kv_shards": engine._kv_shards, "blocks": blocks,
               "packed_row_blocks": qrow,
               "serve_s": wall, "forward_calls": fwd, "launches": launches,
               "shard_weight_bytes": sharded_storage_bytes(qparams, plan, n),
               "shard_pool_bytes": pool_bytes(cfg, engine._pcfg) / engine._kv_shards,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "decode_tokens_per_s": s["decode_tokens_per_s"],
               "decode_ms_per_step": 1e3 * m.decode_s / max(m.decode_steps, 1),
               "ttft_p50": s["ttft_p50"], "kv_shared_tokens": s["kv_shared_tokens"],
               "kv_cow_copies": s["kv_cow_copies"]}
        for k, v in launches.items():
            res["launches"][k] = res["launches"].get(k, 0) + v
        out["profile"] = profile_serving(engine, cfg)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        lap(tag)
        return out

    # internlm2_1_8b: phase 3b's params and requests, tp=1 mesh and tp=2
    for tag, mesh in (("internlm2_1_8b tp=1 mesh", make_tp_mesh(1)),
                      ("internlm2_1_8b tp=2", TPMesh([card] * 2))):
        r = res["runs"][tag] = run(tag, k["qparams"], k["cfg"], k["ecfg"], mesh,
                                   k["requests"], k["streams"],
                                   kv_bits=k["kv_bits"], kv_ranges=k["ranges"])
        if r["kv_shards"] != mesh.size:
            raise AssertionError(f"tp {tag}: pools not sharded by kv head")

    # olmoe_1b_7b: expert parallelism, against its plain engine
    k = kept["olmoe_1b_7b"]
    ecfg = dataclasses.replace(k["ecfg"], clock="steps")

    def moe_reqs():
        rs = poisson_requests(k["cfg"], 4, rate=1.0, prompt_len=(8, 16),
                              gen_len=8, seed=3)
        for q in rs:
            q.arrival_time = 0.0
        return rs

    plain, _ = Engine(k["qparams"], k["cfg"], ecfg, kv_bits=k["kv_bits"],
                      kv_ranges=k["ranges"]).run(moe_reqs())
    lap("olmoe_1b_7b plain engine")
    tag = "olmoe_1b_7b tp=2"
    r = res["runs"][tag] = run(tag, k["qparams"], k["cfg"], ecfg,
                               TPMesh([card] * 2), moe_reqs,
                               [q.output_tokens.tolist() for q in plain],
                               kv_bits=k["kv_bits"], kv_ranges=k["ranges"])
    fwd = r["forward_calls"]
    if r["launches"]["grouped_qmm"] != r["blocks"]["ep"] * 2 * fwd or not r["blocks"]["ep"]:
        raise AssertionError(f"tp {tag}: {r['launches']['grouped_qmm']} grouped_qmm "
                             f"launches for {r['blocks']['ep']} expert-parallel "
                             f"blocks x 2 shards x {fwd} forward calls")
    del plain

    # the serving CLI's int8-backed params at tp=2, with a shared prefix
    cfg = dataclasses.replace(get_config("internlm2_1_8b"),
                              num_layers=TP_INT8_LAYERS)
    params = init_params(cfg, seed=0)
    qparams, scales = quantize_params_int8(params, 8, QuantPolicy())
    del params
    ecfg = dataclasses.replace(k["ecfg"], max_slots=3, max_len=48,
                               max_new_tokens=8, clock="steps",
                               prefix_sharing=True)
    trace = [(0.0, 40, 8), (0.0, 30, 8), (0.0, 35, 8)]

    def int8_reqs():
        return trace_requests(cfg, trace, prefix_len=24)

    plain, pm = Engine(qparams, cfg, ecfg, scales=scales, kv_bits=8).run(int8_reqs())
    lap("int8-backed params and plain engine")
    tag = f"internlm2_1_8b int8-backed tp=2 ({TP_INT8_LAYERS} layers)"
    r = res["runs"][tag] = run(tag, qparams, cfg, ecfg, TPMesh([card] * 2),
                               int8_reqs, [q.output_tokens.tolist() for q in plain],
                               scales=scales, kv_bits=8)
    ps = pm.summary()
    if (r["kv_shared_tokens"], r["kv_cow_copies"]) != (
            ps["kv_shared_tokens"], ps["kv_cow_copies"]) or not ps["kv_cow_copies"]:
        raise AssertionError(f"tp {tag}: sharing {r['kv_shared_tokens']} tokens / "
                             f"{r['kv_cow_copies']} COW copies vs tp=1's "
                             f"{ps['kv_shared_tokens']} / {ps['kv_cow_copies']}")
    if r["launches"]["int8_matmul"] != r["blocks"]["col"] * 2 * r["forward_calls"]:
        raise AssertionError(f"tp {tag}: {r['launches']['int8_matmul']} int8_matmul "
                             f"launches for {r['blocks']['col']} column blocks")
    for name in PATH_KERNELS["tp"]:
        if res["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "tensor-parallel path")
    del plain, qparams, scales
    k = kept["internlm2_1_8b"]
    res["plain_step_after"] = decode_step_ab({"plain": Engine(
        k["qparams"], k["cfg"], k["ecfg"], kv_bits=k["kv_bits"],
        kv_ranges=k["ranges"])})
    lap("plain decode step again")
    return res


SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
SPEC_K, SPEC_DRAFT_AVG_BITS, SPEC_DRAFT_KV_BITS = 4, 3.0, 4
MOE_SPEC_K, MOE_CAPACITY = 3, 8.0     # capacity 8: non-binding at 4 slots


def multi_token_check(params, cfg, ctx, state, t: int = 5) -> dict:
    """R1 on the card: a ``t``-token ``decode_step`` after a 6-token
    prefill equals ``t`` one-token steps, ``torch.equal`` on the logits
    and on the cache left behind. ``state()`` makes a fresh state (the
    caches update in place, so each side prefills its own)."""
    from repro_torch.models.decode import decode_step, prefill_into

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    fresh = state()
    b = fresh.pos.shape[0]
    toks = torch.randint(0, cfg.vocab_size, (b, 6 + t), generator=gen,
                         device="cuda", dtype=torch.int32)
    with torch.no_grad():
        _, sa = prefill_into(params, fresh, toks[:, :6], cfg, ctx=ctx)
        seq = []
        for j in range(t):
            lg, sa = decode_step(params, sa, toks[:, 6 + j:7 + j], cfg, ctx=ctx)
            seq.append(lg[:, 0])
        _, sb = prefill_into(params, state(), toks[:, :6], cfg, ctx=ctx)
        fused, sb = decode_step(params, sb, toks[:, 6:], cfg, ctx=ctx)
    torch.cuda.synchronize()
    seq = torch.stack(seq, 1)
    if sa.paged is not None:
        pairs = [(la.k, sb.paged.layers[n].k) for n, la in sa.paged.layers.items()]
        pairs += [(la.v, sb.paged.layers[n].v) for n, la in sa.paged.layers.items()]
    else:
        pairs = [(sa.kv.k, sb.kv.k), (sa.kv.v, sb.kv.v)]
    caches = all(torch.equal(x, y) for x, y in pairs)
    ok = torch.equal(seq, fused) and caches and torch.equal(sa.pos, sb.pos)
    return {"logits_equal": torch.equal(seq, fused), "caches_equal": caches,
            "max_abs_diff": (seq.float() - fused.float()).abs().max().item(),
            "ok": ok}


def sampler_ab(engine, turns: int = 3, steps: int = 8) -> dict:
    """Host-clock ms of a decode step plus its sampler at batch
    ``max_slots``, greedy (argmax) against the full sampler (temperature,
    top-k, top-p: two sorts of the vocabulary, the Threefry noise), in
    turns; and the sampler alone on those logits, CUDA-event timed."""
    from repro_torch.models.decode import decode_step
    from repro_torch.serve.sampling import (greedy_tokens, request_keys,
                                            sample_tokens)

    ec, cfg, dev = engine.ecfg, engine.cfg, engine.device
    s, npp = ec.max_slots, ec.max_len // ec.page_size
    st = engine._fresh_state()
    st.paged.table.copy_(torch.arange(s * npp, dtype=torch.int32).reshape(s, npp))
    st.paged.write_limit.fill_(ec.max_len)
    tok = torch.zeros((s, 1), dtype=torch.int32, device=dev)
    seeds = torch.arange(s, dtype=torch.int32, device=dev)
    temp = torch.full((s,), SAMPLED["temperature"], device=dev)
    top_k = torch.full((s,), SAMPLED["top_k"], dtype=torch.int32, device=dev)
    top_p = torch.full((s,), SAMPLED["top_p"], device=dev)
    nw = torch.zeros(s, dtype=torch.int64, device=dev)

    def sample(mode, lg, i):
        if mode == "greedy":
            return greedy_tokens(lg)
        return sample_tokens(lg, request_keys(seeds, nw + i), temp, top_k, top_p)

    def timed(mode):
        nonlocal st
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = tok
        for i in range(steps):
            lg, st = decode_step(engine.params, st, t, cfg, ctx=engine._ctx)
            t = sample(mode, lg[:, 0, :cfg.vocab_size], i)[:, None]
        torch.cuda.synchronize()
        st = st._replace(pos=st.pos - steps)
        return 1e3 * (time.perf_counter() - t0) / steps

    times = {"greedy": [], "full": []}
    with torch.no_grad():
        timed("greedy")
        for mode in ["greedy", "full", "full", "greedy"] * turns:
            times[mode].append(timed(mode))
        lg, _ = decode_step(engine.params, st, tok, cfg, ctx=engine._ctx)
        lg = lg[:, 0, :cfg.vocab_size].contiguous()
        timer = Timer()
        alone = {m: timer(lambda m=m: sample(m, lg, 0)) for m in times}
    return {"batch": s, "vocab": cfg.vocab_size, "ms_per_step": times,
            "median_ms": {k: statistics.median(v) for k, v in times.items()},
            "sampler_ms": alone}


def spec_path(kept: dict) -> dict:
    """Phase 3g: sampled and self-speculative serving at full width on
    phase 3b's params and report (run right after 3f). Each serving run's
    counters are set to 0 just before it and read just after.

      * R1 on the card: a 5-token decode equals 5 one-token steps
        (``torch.equal``, logits and cache) on internlm2_1_8b at
        int8_compute True and False, over 3b's paged pools and over a
        dense cache;
      * sampled serving (temperature 0.8, top-k 50, top-p 0.95, a seed a
        request) of 8 Poisson requests on 3b's engine: two runs give
        equal streams, requests 0 and 5 alone equal the batch, and tp=2
        (two shards on this card) equals tp=1;
      * speculative serving, k = 4, the draft narrowed by
        ``allocate_draft_bits(report, avg_bits=3.0)`` and materialized:
        paged with 4-bit draft pools and dense with the int8 lane, greedy
        and sampled; every stream equals the plain engine's; the paged
        greedy pair is timed in turns (plain, spec, spec, plain);
      * olmoe_1b_7b, k = 3, greedy, capacity factor 8 (non-binding), the
        serving tree as its own draft on the integer kernels with 4-bit
        draft pools: streams equal plain;
      * ``launch.serve.serve()`` at full width with int8-backed W8 through
        int8_matmul, sampled, ``spec_k=4, spec_kv_bits=4``: streams equal
        the same engine's plain run; then the CLI itself at smoke size in
        a subprocess with ``--spec-k 4 --spec-kv-bits 4 --temperature
        0.8``;
      * the sampler's cost: a decode step with the full sampler against a
        greedy one, in turns (``sampler_ab``)."""
    from repro_torch.core.fit import allocate_draft_bits
    from repro_torch.launch.mesh import TPMesh
    from repro_torch.launch.serve import serve
    from repro_torch.models.context import DequantContext
    from repro_torch.models.decode import init_decode_state
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.loadgen import poisson_requests
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.spec import SpecConfig

    card = torch.device("cuda", 0)
    res = {"runs": {}, "launches": {}, "seconds": {}, "launches_by_path": {}}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        res["seconds"][name] = now - clock[0]
        clock[0] = now

    def run(tag, engine, reqs, path):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        fin, m = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        for k, v in launches.items():
            res["launches"][k] = res["launches"].get(k, 0) + v
            by = res["launches_by_path"].setdefault(path, {})
            by[k] = by.get(k, 0) + v
        for r in fin:
            if r.num_generated != r.max_new_tokens or not (
                    (r.output_tokens >= 0) & (r.output_tokens < engine.cfg.vocab_size)).all():
                raise AssertionError(f"3g {tag}: request {r.id} unfinished or "
                                     "out of the vocab")
        s = m.summary()
        out = {"serve_s": wall, "decode_s": m.decode_s,
               "decode_tokens": m.decode_tokens,
               "decode_tokens_per_s": s["decode_tokens_per_s"]}
        if engine._spec is not None:
            st = dict(engine.spec_stats)
            st["accept_rate"] = st["accepted"] / max(st["proposed"], 1)
            out["spec"] = st
        res["runs"][tag] = out
        return [r.output_tokens.tolist() for r in fin]

    def same(tag, got, want):
        if got != want:
            raise AssertionError(f"3g {tag}: streams differ: {got} vs {want}")

    k = kept["internlm2_1_8b"]
    cfg, qp, ecfg = k["cfg"], k["qparams"], k["ecfg"]
    kw = dict(kv_bits=k["kv_bits"], kv_ranges=k["ranges"])
    plain = Engine(qp, cfg, ecfg, **kw)

    # ---- R1 on the card ----
    def paged_state():
        st = plain._fresh_state()
        npp = ecfg.max_len // ecfg.page_size
        st.paged.table.copy_(torch.arange(ecfg.max_slots * npp, dtype=torch.int32)
                             .reshape(ecfg.max_slots, npp))
        st.paged.write_limit.fill_(ecfg.max_len)
        return st

    def dense_state():
        return init_decode_state(cfg, ecfg.max_slots, 64, per_slot_pos=True)

    res["multi_token"] = {}
    for int8c in (True, False):
        ctx = DequantContext(None, cfg.param_dtype, int8_compute=int8c)
        for name, state in (("paged", paged_state), ("dense", dense_state)):
            tag = f"int8_compute={int8c} {name}"
            r = res["multi_token"][tag] = multi_token_check(qp, cfg, ctx, state)
            if not r["ok"]:
                raise AssertionError(f"3g multi-token decode != sequential ({tag}): {r}")
    lap("multi-token checks")

    # ---- sampled serving ----
    def sampled_reqs():
        return poisson_requests(cfg, 8, rate=4.0, prompt_len=(8, 16),
                                gen_len=(8, 16), sampling=SamplingParams(
                                    seed=100, **SAMPLED), seed=4)

    s1 = run("sampled", plain, sampled_reqs(), "sampled")
    same("sampled run 2", run("sampled again", plain, sampled_reqs(), "sampled"), s1)
    for rid in (0, 5):
        alone = [r for r in sampled_reqs() if r.id == rid]
        alone[0].arrival_time = 0.0
        same(f"sampled request {rid} alone",
             run(f"sampled request {rid} alone", plain, alone, "sampled"), [s1[rid]])
    tp2 = Engine(qp, cfg, dataclasses.replace(ecfg, mesh=TPMesh([card] * 2)), **kw)
    same("sampled tp=2", run("sampled tp=2", tp2, sampled_reqs(), "sampled_tp"), s1)
    del tp2
    lap("sampled serving")

    # ---- speculative serving ----
    plan = allocate_draft_bits(k["report"], avg_bits=SPEC_DRAFT_AVG_BITS)
    res["draft_plan"] = {"avg_bits": plan.avg_bits, "kl_proxy": plan.kl_proxy,
                         "accept_proxy": plan.accept_proxy,
                         "bit_histogram": {str(b): sum(v == b for v in
                                                       plan.bits.weight_bits.values())
                                           for b in sorted(set(plan.bits.weight_bits.values()))}}
    spec_cfg = SpecConfig(k=SPEC_K, draft_bits=plan.bits,
                          draft_kv_bits=SPEC_DRAFT_KV_BITS)
    spec = Engine(qp, cfg, dataclasses.replace(ecfg, spec=spec_cfg), **kw)
    lap("draft tree")

    def spec_reqs(sampled=False):
        return poisson_requests(
            cfg, 4, rate=4.0, prompt_len=(8, 16), gen_len=(12, 20), seed=6,
            sampling=SamplingParams(seed=200, **SAMPLED) if sampled else None)

    p1 = run("plain paged greedy 1", plain, spec_reqs(), "plain")
    same("spec paged greedy 1", run("spec paged greedy 1", spec, spec_reqs(), "spec"), p1)
    same("spec paged greedy 2", run("spec paged greedy 2", spec, spec_reqs(), "spec"), p1)
    same("plain paged greedy 2", run("plain paged greedy 2", plain, spec_reqs(), "plain"), p1)
    same("spec paged sampled", run("spec paged sampled", spec, spec_reqs(True), "spec"),
         run("plain paged sampled", plain, spec_reqs(True), "plain"))
    del spec
    dense_ecfg = dataclasses.replace(ecfg, kv_cache="dense")
    dplain = Engine(qp, cfg, dense_ecfg)
    dspec = Engine(qp, cfg, dataclasses.replace(
        dense_ecfg, spec=dataclasses.replace(spec_cfg, draft_kv_bits=8)))
    for sampled in (False, True):
        mode = "sampled" if sampled else "greedy"
        same(f"spec dense {mode}",
             run(f"spec dense {mode}", dspec, spec_reqs(sampled), "spec"),
             run(f"plain dense {mode}", dplain, spec_reqs(sampled), "plain"))
    del dplain, dspec
    lap("speculative serving")

    # ---- olmoe_1b_7b: k = 3 at a non-binding capacity ----
    km = kept["olmoe_1b_7b"]
    mcfg = dataclasses.replace(km["cfg"], capacity_factor=MOE_CAPACITY)
    mecfg = dataclasses.replace(km["ecfg"], clock="steps")
    mkw = dict(kv_bits=km["kv_bits"], kv_ranges=km["ranges"])

    def moe_reqs():
        rs = poisson_requests(mcfg, 3, rate=1.0, prompt_len=(8, 12),
                              gen_len=16, seed=7)
        for r in rs:
            r.arrival_time = 0.0
        return rs

    mplain = run("olmoe plain", Engine(km["qparams"], mcfg, mecfg, **mkw),
                 moe_reqs(), "plain_moe")
    mspec = Engine(km["qparams"], mcfg, dataclasses.replace(mecfg, spec=SpecConfig(
        k=MOE_SPEC_K, draft_kv_bits=SPEC_DRAFT_KV_BITS, int8_compute=True,
        materialize_draft=False)), **mkw)
    same("olmoe spec", run("olmoe spec", mspec, moe_reqs(), "spec_moe"), mplain)
    del mspec
    lap("olmoe speculative serving")

    # ---- the serving CLI's int8-backed path, sampled and speculative ----
    reset_counts()
    t0 = time.perf_counter()
    out = serve("internlm2_1_8b", False, 4, 16, 16, 8, int8=True,
                int8_compute=True, n_requests=4, rate=4.0, paged=True,
                page_size=16, kv_bits=8, spec_k=SPEC_K,
                spec_kv_bits=SPEC_DRAFT_KV_BITS,
                sampling=SamplingParams(seed=300, **SAMPLED))
    torch.cuda.synchronize()
    launches = read_counts()
    for name, v in launches.items():
        res["launches"][name] = res["launches"].get(name, 0) + v
    res["launches_by_path"]["spec_int8"] = launches
    eng = out["engine"]
    got = [r.output_tokens.tolist() for r in out["requests"]]
    pe = Engine(eng.params, eng.cfg, dataclasses.replace(eng.ecfg, spec=None),
                scales=eng.scales, kv_bits=8)
    want, _ = pe.run(poisson_requests(
        eng.cfg, 4, 4.0, prompt_len=(8, 16), gen_len=(8, 16),
        sampling=SamplingParams(seed=300, **SAMPLED), seed=0))
    same("launch.serve int8-backed spec", got, [r.output_tokens.tolist() for r in want])
    res["runs"]["launch.serve int8-backed sampled spec"] = {
        "serve_s": time.perf_counter() - t0, "spec": out["spec"],
        "decode_tokens_per_s": out["tokens_per_s"]}
    del out, eng, pe
    gc.collect()
    torch.cuda.empty_cache()
    lap("launch.serve int8-backed sampled spec")
    res["cli_smoke"] = run_spec_cli_smoke()
    lap("CLI subprocess")

    res["sampler_ab"] = sampler_ab(plain, turns=2)
    lap("sampler A/B")
    for path, names in PATH_KERNELS.items():
        if path in res["launches_by_path"]:
            for name in names:
                if res["launches_by_path"][path].get(name, 0) <= 0:
                    raise AssertionError(f"3g: kernel {name} was not launched by "
                                         f"the {path} runs")
    return res


def run_spec_cli_smoke() -> dict:
    """``python -m repro_torch.launch.serve`` at smoke size with sampling
    and speculation in a subprocess on this card (``--int8 --int8-compute
    --paged --spec-k 4 --spec-kv-bits 4 --temperature 0.8 --top-k 50
    --top-p 0.95``); its dump holds the ``"spec"`` entry."""
    import os

    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "internlm2_1_8b", "--smoke", "--int8", "--int8-compute", "--paged",
           "--requests", "4", "--rate", "0.05", "--spec-k", "4",
           "--spec-kv-bits", "4", "--temperature", "0.8", "--top-k", "50",
           "--top-p", "0.95"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"launch.serve CLI exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    dump = json.loads(proc.stdout)
    sp = dump.get("spec")
    if dump["metrics"]["n_finished"] != 4 or not sp or sp["dispatches"] <= 0:
        raise AssertionError(f"launch.serve CLI with spec and sampling: {dump}")
    return {"wall_s": time.perf_counter() - t0, "spec": sp,
            "n_finished": dump["metrics"]["n_finished"]}


def cli_path():
    """Phase 3c: ``launch.serve.serve()`` as the CLI runs it (``--arch
    internlm2_1_8b --batch 4 --prompt-len 64 --gen-len 32 --weight-bits 8
    --int8 --int8-compute --requests 8 --rate 4 --clock wall --paged
    --page-size 16 --kv-bits 8 --shared-prefix 24``) at full width. The
    prefix ends inside a page, so admission shares a full page and
    copies the boundary page on write."""
    from repro_torch.launch.serve import serve

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = serve("internlm2_1_8b", False, 4, 64, 32, 8, int8=True,
                int8_compute=True, n_requests=8, rate=4.0, clock="wall",
                paged=True, page_size=16, kv_bits=8, shared_prefix=24)
    torch.cuda.synchronize()
    res = {"serve_s": time.perf_counter() - t0, "launches": read_counts()}
    engine = out["engine"]
    cfg = engine.cfg
    fin = out["requests"]
    if len(fin) != 8:
        raise AssertionError(f"launch.serve: {len(fin)} of 8 requests finished")
    for r in fin:
        if r.num_generated != r.max_new_tokens:
            raise AssertionError(f"launch.serve request {r.id}: "
                                 f"{r.num_generated} of {r.max_new_tokens} tokens")
        if not ((r.output_tokens >= 0) & (r.output_tokens < cfg.vocab_size)).all():
            raise AssertionError(f"launch.serve request {r.id}: token out of the vocab")
    for name in PATH_KERNELS["cli"]:
        if res["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the CLI path")
    for name in CLI_IDLE_KERNELS:
        if res["launches"][name] != 0:
            raise AssertionError(f"kernel {name} was launched by the int8-backed "
                                 "CLI path")
    s = out["metrics"]
    if not (s["kv_shared_tokens"] > 0 and s["kv_cow_copies"] > 0):
        raise AssertionError(f"launch.serve: no prefix sharing ({s['kv_shared_tokens']} "
                             f"tokens, {s['kv_cow_copies']} COW copies)")
    res.update({k: s[k] for k in ("decode_tokens_per_s", "prefill_tokens_per_s",
                                  "ttft_p50", "ttft_p95", "e2e_p50",
                                  "token_latency_p50_ms", "decode_tokens",
                                  "kv_shared_tokens", "kv_cow_copies",
                                  "kv_peak_bytes", "kv_pool_bytes")})
    res["weight_bytes"] = out["weight_bytes"]
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["sharing_contract"] = check_sharing_contract(engine)
    res["profile"] = profile_serving(engine, cfg)
    res["cli_smoke"] = run_cli_smoke()
    return res


def check_sharing_contract(engine) -> dict:
    """Three short requests with a 24-token shared prefix over the CLI
    engine's weights: paged bf16 pages with sharing give the greedy
    streams of paged pages without sharing and of the dense cache."""
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.loadgen import trace_requests

    cfg = engine.cfg
    trace = [(0.0, 40, 8), (0.0, 30, 8), (0.0, 35, 8)]
    base = dict(max_slots=3, max_len=48, max_new_tokens=8, prefill_chunk=32,
                int8_compute=True)
    outs, shared = {}, {}
    for name, kw in (("paged_shared", dict(kv_cache="paged", page_size=16)),
                     ("paged_unshared", dict(kv_cache="paged", page_size=16,
                                             prefix_sharing=False)),
                     ("dense", dict(kv_cache="dense"))):
        eng = Engine(engine.params, cfg, EngineConfig(**base, **kw),
                     scales=engine.scales)
        fin, m = eng.run(trace_requests(cfg, trace, prefix_len=24))
        outs[name] = [r.output_tokens.tolist() for r in fin]
        shared[name] = m.summary()["kv_shared_tokens"]
        del eng
    if not shared["paged_shared"]:
        raise AssertionError("sharing contract: no prefix was shared")
    for name in ("paged_unshared", "dense"):
        if outs[name] != outs["paged_shared"]:
            raise AssertionError(f"sharing contract: paged shared != {name}: {outs}")
    return {"requests": len(trace), "tokens": sum(map(len, outs["dense"])),
            "kv_shared_tokens": shared["paged_shared"]}


def run_cli_smoke() -> dict:
    """``python -m repro_torch.launch.serve`` itself on the smoke config, in
    a subprocess on this card; its standard output is the JSON dump."""
    import os

    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "internlm2_1_8b", "--smoke", "--int8", "--int8-compute", "--paged",
           "--kv-bits", "8", "--requests", "4", "--rate", "0.05"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"launch.serve CLI exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    dump = json.loads(proc.stdout)
    if dump["metrics"]["n_finished"] != 4:
        raise AssertionError(f"launch.serve CLI: {dump['metrics']['n_finished']} "
                             "of 4 requests finished")
    return {"wall_s": time.perf_counter() - t0,
            "n_finished": dump["metrics"]["n_finished"],
            "decode_tokens": dump["metrics"]["decode_tokens"]}


def _bcast(t: torch.Tensor, x: torch.Tensor, axis) -> torch.Tensor:
    """Per-channel scales reshaped to broadcast along ``axis`` of x."""
    if axis is None:
        return t
    shape = [1] * x.ndim
    shape[axis % x.ndim] = -1
    return t.reshape(shape)


def _check_fq(x, spec, s, zp, g):
    """``quant.fake_quant`` of x on (s, zp) through the STE: the output
    equals the plain version bit for bit and x.grad of (y·g).sum() is g."""
    from repro_torch.kernels import ref
    from repro_torch.quant import fake_quant

    xg = x.detach().requires_grad_(True)
    y = fake_quant(xg, spec, s, zp)
    want = ref.fake_quant(x, _bcast(s, x, spec.channel_axis),
                          _bcast(zp, x, spec.channel_axis), spec.bits,
                          float(spec.levels))
    (y * g).sum().backward()
    if not torch.equal(y, want):
        raise AssertionError(f"fake_quant {spec}: differs from the plain version")
    if not torch.equal(xg.grad, g):
        raise AssertionError(f"fake_quant {spec}: the STE gradient is not g")


def library_path(arch: str = "internlm2_1_8b", calib_batches: int = 2,
                 calib_seq: int = 512, attn_seq: int = 2048):
    """Phase 3d: the quantization library at full width. Calibrate the
    activation ranges of every tap site over ``calib_batches`` forward
    passes (CollectContext -> MinMaxObserver and EmaObserver(0.99)), then
    fake-quantize through the STE every weight matmul block (W4 per
    tensor, W8 symmetric per channel on the last axis and on axis 0) and
    every recorded activation (A8 on its EMA range), each held against
    the plain version and its gradient against g; then flash attention
    on layer 0's own causal q, k, v at ``attn_seq`` tokens against the
    model's ``chunked_attention``. Counters are reset just before and
    read just after."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import LMStreamConfig, lm_batches
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import batch_to_device
    from repro_torch.models.attention import chunked_attention
    from repro_torch.models.context import CollectContext
    from repro_torch.models.layers import apply_rope, rmsnorm
    from repro_torch.models.transformer import forward, init_params
    from repro_torch.quant import EmaObserver, MinMaxObserver, QuantSpec
    from repro_torch.quant.calibration import init_range_state
    from repro_torch.quant.quantizer import quant_params
    from repro_torch.utils.pytree import named_leaves

    cfg = get_config(arch)
    dev = torch.device("cuda")
    res = {"arch": arch, "layers": cfg.num_layers}
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()

    # 1. calibration
    stream = lm_batches(LMStreamConfig(vocab_size=cfg.vocab_size,
                                       seq_len=calib_seq, global_batch=2, seed=0))
    mm, ema = MinMaxObserver(), EmaObserver(0.99)
    ranges: dict = {}
    with torch.no_grad():
        for _ in range(calib_batches):
            ctx = CollectContext()
            forward(params, batch_to_device(next(stream), dev), cfg, ctx=ctx)
            for site, a in ctx.acts.items():
                st_mm, st_ema = ranges.get(site, (init_range_state(),
                                                  init_range_state()))
                ranges[site] = (mm.update(st_mm, a), ema.update(st_ema, a))
    acts = ctx.acts
    torch.cuda.synchronize()
    res["calibrate_s"] = time.perf_counter() - t0
    res["act_sites"] = len(acts)
    widest = max(acts, key=lambda k: float(ranges[k][0].hi - ranges[k][0].lo))
    res["widest_site"] = {"site": widest,
                          "minmax": [float(ranges[widest][0].lo),
                                     float(ranges[widest][0].hi)],
                          "ema": [float(ranges[widest][1].lo),
                                  float(ranges[widest][1].hi)]}

    # 2-3. weights and activations through the STE, against the plain version
    t0 = time.perf_counter()
    blocks = [(n, w) for n, w in named_leaves(params)
              if w.ndim == 2 and (n == "head" or "/attn/w" in n or "/mlp/w" in n)]
    gs: dict = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def grad_for(x):
        key = (tuple(x.shape), x.dtype)
        if key not in gs:
            gs[key] = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        return gs[key]

    wspecs = (QuantSpec(4), QuantSpec(8, symmetric=True, channel_axis=-1),
              QuantSpec(8, symmetric=True, channel_axis=0))
    for _, w in blocks:
        for spec in wspecs:
            s, zp = quant_params(w, spec)
            _check_fq(w, spec, s, zp, grad_for(w))
    a8 = QuantSpec(8)
    for site, a in acts.items():
        st = ranges[site][1]
        s, zp = quant_params(torch.stack([st.lo, st.hi]), a8)
        _check_fq(a, a8, s, zp, grad_for(a))
    torch.cuda.synchronize()
    res["fake_quant_s"] = time.perf_counter() - t0
    res["weight_blocks"] = len(blocks)
    del gs, acts, ctx

    # 4. flash attention on layer 0's causal q, k, v
    b, h, kvh, hd = 2, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tokens = next(lm_batches(LMStreamConfig(vocab_size=cfg.vocab_size,
                                            seq_len=attn_seq, global_batch=b,
                                            seed=1)))["tokens"]
    with torch.no_grad():
        x = params["embed"][torch.from_numpy(tokens).to(dev).long()]
        lp = params["layers"]["0"]
        hx = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        pos = torch.arange(attn_seq, device=dev)
        q = apply_rope((hx @ lp["attn"]["wq"]).reshape(b, attn_seq, h, hd), pos,
                       cfg.rope_theta)
        k = apply_rope((hx @ lp["attn"]["wk"]).reshape(b, attn_seq, kvh, hd), pos,
                       cfg.rope_theta)
        v = (hx @ lp["attn"]["wv"]).reshape(b, attn_seq, kvh, hd)
        k = torch.repeat_interleave(k, h // kvh, dim=2)
        v = torch.repeat_interleave(v, h // kvh, dim=2)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ops.flash_attention(qt, kt, vt, causal=True)
        torch.cuda.synchronize()
        res["flash_s"] = time.perf_counter() - t0
        want = chunked_attention(q, k, v, causal=True,
                                 chunk=cfg.attn_chunk).transpose(1, 2).float()
        mag = ref.flash_attention(qt.float(), kt.float(), vt.float().abs())
        diff = (got.float() - want).abs()
        # the tolerance of phase 2's bf16 rows: both round P (per tile or
        # per chunk) and the output to bf16
        ratio = (diff / (2.0 ** -7 * (mag + want.abs()) + 1e-6)).max().item()
    res["flash_vs_chunked"] = {"shape": f"B={b} H={h} S={attn_seq} D={hd} "
                                        f"{str(qt.dtype)[6:]}",
                               "max_abs_err": diff.max().item(),
                               "tolerance_share": ratio}
    if not (torch.isfinite(got).all() and ratio <= 1.0):
        raise AssertionError(f"flash_attention vs chunked_attention: "
                             f"{res['flash_vs_chunked']}")
    res["launches"] = read_counts()
    for name in PATH_KERNELS["library"]:
        if res["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "library path")
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


TRAIN_LR = 1e-3        # random-init 1.8B, 2 warmup steps, bf16 master-free


def train_path(arch: str = "internlm2_1_8b", steps: int = 12, batch: int = 4,
               seq: int = 512):
    """Phase 3e: QAT training (W4 weights, A8 activations) at full width
    and depth through ``launch.train.train``; then the resume contract at
    full width and 2 layers (a crash after the step-3 checkpoint: the
    resumed losses 3..5 equal the first run's); then the training CLI on
    the smoke config in a subprocess. QAT fake-quantizes with plain ops,
    as the reference does: the path launches none of the kernels."""
    import shutil
    import tempfile

    from repro_torch.launch import train as tmod

    qat = dict(qat_weight_bits=4, qat_act_bits=8, watchdog_s=None,
               lr=TRAIN_LR, log_every=1)
    res = {"arch": arch, "steps": steps, "batch": batch, "seq": seq,
           "lr": TRAIN_LR}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = tmod.train(arch, False, steps, batch, seq, None, False, 0, **qat)
    torch.cuda.synchronize()
    res["wall_s"] = time.perf_counter() - t0
    res["launches"] = read_counts()
    losses = out["losses"]
    res["losses"] = losses
    res["step_s"] = out["step_s"]
    steady = statistics.median(out["step_s"][1:])
    res["s_per_step"] = steady
    res["tokens_per_s"] = batch * seq / steady
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"QAT training: losses {losses}")
    if any(res["launches"].values()):
        raise AssertionError(f"QAT training launched a kernel: {res['launches']}")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    res["profile"] = profile_training(arch, batch, seq)

    # resume contract: full width, 2 layers (checkpoints of ~5 GB)
    gc.collect()
    torch.cuda.empty_cache()
    full = tmod.get_config
    tmod.get_config = lambda name: dataclasses.replace(full(name), num_layers=2)
    tmp = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        kw = dict(ckpt_dir=tmp, ckpt_every=3, **qat)
        t0 = time.perf_counter()
        first = tmod.train(arch, False, 6, batch, seq, resume=False, **kw)
        (Path(tmp) / "LATEST").write_text("step_00000003")
        again = tmod.train(arch, False, 6, batch, seq, resume=True, **kw)
        res["resume"] = {"layers": 2, "first": first["losses"],
                         "resumed": again["losses"],
                         "wall_s": time.perf_counter() - t0,
                         "ckpt_bytes": sum(f.stat().st_size for f in
                                           Path(tmp).rglob("arrays.npz"))}
        if again["losses"] != first["losses"][3:]:
            raise AssertionError(f"resume: losses {again['losses']} != "
                                 f"{first['losses'][3:]}")
    finally:
        tmod.get_config = full
        shutil.rmtree(tmp, ignore_errors=True)
    res["cli_smoke"] = run_train_cli_smoke()
    return res


def run_train_cli_smoke() -> dict:
    """``python -m repro_torch.launch.train`` on the smoke config with W4A8
    QAT and checkpoints every 3 steps, in a subprocess on this card."""
    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="repro_torch_cli_ckpt_")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "internlm2_1_8b", "--smoke", "--steps", "6", "--batch", "4", "--seq",
           "32", "--qat-weight-bits", "4", "--qat-act-bits", "8", "--ckpt-dir",
           tmp, "--ckpt-every", "3"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              cwd=str(ROOT), timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"launch.train CLI exited {proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
        latest = (Path(tmp) / "LATEST").read_text()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if latest != "step_00000006":
        raise AssertionError(f"launch.train CLI: LATEST is {latest!r}")
    return {"wall_s": time.perf_counter() - t0, "latest": latest,
            "final_log": proc.stderr.strip().splitlines()[-1][-160:]}


def check_grouped_equals_dense(qparams, cfg, ecfg, kv_bits, ranges) -> dict:
    """Two short requests served with moe_dispatch="grouped" (one
    grouped_qmm per projection) and "dense" (the per-expert qmm kernel
    loop): identical greedy token streams."""
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.loadgen import poisson_requests

    outs = {}
    for dispatch in ("grouped", "dense"):
        reqs = poisson_requests(cfg, 2, rate=1.0, prompt_len=(8, 16),
                                gen_len=8, seed=3)
        for r in reqs:
            r.arrival_time = 0.0
        eng = Engine(qparams, cfg, dataclasses.replace(ecfg, moe_dispatch=dispatch),
                     kv_bits=kv_bits, kv_ranges=ranges)
        fin, _ = eng.run(reqs)
        outs[dispatch] = [r.output_tokens.tolist() for r in fin]
    if outs["grouped"] != outs["dense"]:
        raise AssertionError(f"grouped != dense token streams: {outs}")
    return {"requests": len(outs["grouped"]),
            "tokens": sum(len(t) for t in outs["grouped"])}


def profile_serving(engine, cfg, n_top: int = 10):
    """Where the serving time goes: 4 requests (prompt 8, 16 new tokens)
    served once without and once under torch.profiler (device activity
    only), on an engine that has served already. Device busy share = summed kernel time (one stream, so kernels
    do not overlap) over the unprofiled wall time; the rest is the host
    (Python dispatch)."""
    from repro_torch.serve.loadgen import poisson_requests

    def reqs():
        rs = poisson_requests(cfg, 4, rate=1.0, prompt_len=8, gen_len=16,
                              seed=2)
        for r in rs:
            r.arrival_time = 0.0
        return rs

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = engine.run(reqs())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy_s, top = device_kernels(lambda: engine.run(reqs()), n_top)
    s = m.summary()
    return {"wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall,
            "prefill_s": m.prefill_s, "decode_s": m.decode_s,
            "decode_steps": m.decode_steps,
            "decode_ms_per_step": 1e3 * m.decode_s / max(m.decode_steps, 1),
            "prefill_ms_per_token": 1e3 * m.prefill_s / max(m.prefill_tokens, 1),
            "decode_tokens_per_s": s["decode_tokens_per_s"],
            "top_kernels": top}


def device_kernels(fn, n_top: int = 10):
    """Run ``fn`` under torch.profiler (device activity only): (summed
    device seconds, the ``n_top`` kernels by device time). One stream, so
    kernels do not overlap and the sum is the device's busy time. Reads
    the profiler's raw events: ``key_averages`` builds an event tree in
    Python, slow for the ~10^5 kernels of a serving window."""
    from torch.autograd import DeviceType

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, ns = per.get(e.name(), (0, 0))
            per[e.name()] = (n + 1, ns + e.duration_ns())
    top = sorted(per.items(), key=lambda kv: kv[1][1], reverse=True)[:n_top]
    return (sum(ns for _, ns in per.values()) / 1e9,
            [{"name": name[:90], "count": n, "device_ms": ns / 1e6}
             for name, (n, ns) in top])


def profile_training(arch: str, batch: int, seq: int, steps: int = 2,
                     n_top: int = 12):
    """Where a QAT (W4A8) training step's time goes at full width: one
    warm step, ``steps`` steps timed on the host clock, ``steps`` more
    under torch.profiler. Device busy share = summed kernel time over the
    unprofiled wall time; the rest is the host."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import LMStreamConfig, lm_batches
    from repro_torch.launch.steps import (
        TrainState, batch_to_device, train_step, uniform_levels)
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_adam
    from repro_torch.utils.pytree import named_leaves

    cfg = get_config(arch)
    params = init_params(cfg, seed=0)
    for _, p in named_leaves(params):
        p.requires_grad_(True)
    state = [TrainState(params, init_adam(params))]
    qat = uniform_levels(cfg, 4, 8)
    adam = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=12)
    stream = lm_batches(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                       global_batch=batch, seed=0))
    dev = torch.device("cuda")
    batches = [batch_to_device(next(stream), dev) for _ in range(1 + 2 * steps)]

    def run(bs):
        for b in bs:
            state[0], m = train_step(state[0], b, cfg, adam, qat)
            float(m["loss"])

    run(batches[:1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(batches[1:1 + steps])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy_s, top = device_kernels(lambda: run(batches[1 + steps:]), n_top)
    return {"steps": steps, "s_per_step": wall / steps,
            "device_s_per_step": busy_s / steps, "device_busy_share": busy_s / wall,
            "top_kernels": top}


def kernels_line(rows, paths):
    """One entry per kernel; ``launches`` sums the main paths' runs
    (``paths``: each path's launch counts)."""
    out = []
    for name, source, replaces, shape in KERNELS:
        row = next(r for r in rows if r["kernel"] == name and r["shape"] == shape)
        launches = sum(p.get(name, 0) for p in paths)
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    return out


if __name__ == "__main__":
    sys.exit(main())
