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
     check that one serving call of qmm, int8_matmul and paged_attention,
     and one ef_sqnorm call at each of its rows, is one launch with no
     allocation but its output (and the partials where a context or a row
     spans CTAs), that ef_sqnorm gives the same bits twice and a (4, N)
     call the bits of four (1, N) calls, and that paged_attention's
     slots alone and its kv-head shards equal the batched, full call;
     that each flash row runs the kernel its head dim and dtype plan
     (bf16/fp16 past D = 256: the split-head-dim kernel up to 512, one
     launch with no input copy when a row is whole 16-byte chunks), and
     that every route of the per-channel fake-quant plan is checked;
  3a. the packed paged decode of every ported config's smoke variant
     (SMOKE_ARCHS; the ssm family from its dense state) on the card
     against the CPU plain path;
  3b. drive each main path at full width — internlm2_1_8b,
     llama3_8b, phi3_mini_3_8b and minitron_4b (dense), olmoe_1b_7b and
     deepseek_moe_16b (MoE, grouped_qmm); each but minitron (full depth)
     cut to PATH_LAYERS = 8 layers —
     seeded init -> FIT report
     (its peak memory within 1.3 x the parameter bytes + 2 GB; for
     internlm2_1_8b again on a two-shard data-parallel mesh, equal within
     1e-5) -> W4/W8 bit allocation -> packed QTensors -> FIT KV widths ->
     paged serving of Poisson requests (greedy; alone == batched for the
     dense paths, grouped == dense for MoE), with every kernel launch
     counter reset just before each path and read just after its
     serving run;
  3c. the serving CLI's path at full width and 8 layers:
     repro_torch.launch.serve.serve() on internlm2_1_8b with int8-backed
     W8 weights through int8_matmul, paged int8 KV with a 24-token shared
     prefix (prefix sharing and a copy-on-write page), counters reset
     just before it and read just after; then the sharing contract at
     full width (paged bf16 pages with sharing == the dense cache ==
     paged without sharing), and the CLI itself (python -m
     repro_torch.launch.serve --smoke ...) in a subprocess;
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
  3i. (run right after 3g, on 3b's params) observability: the 4 shortest
     of 3b's requests with tracing, counters and timed dispatches equal
     3b's streams; drained counters equal the host bookkeeping and the
     kernels' launches in the bursts; obs adds at most a synchronizing
     call a drain (set_sync_debug_mode); the trace validates with its
     device track, CUDA-event time within each dispatch's wall; the FIT
     drift monitor at full width and 4 layers, quiet when calibrated and
     flagging 3x stale calibration; the profiling CLI in a subprocess;
     the decode step with and without obs, in turns;
  3h. FIT against the Hessian: internlm2_1_8b at full width and 4
     layers, one batch of 4 x 128: the EF traces and Hutchinson's
     per-block Hessian traces (8 probes, fp32, seeded), each timed, their
     Spearman correlation, finite and deterministic under one seed;
  3j. the recurrent families at full width (``RECURRENT_PATHS``):
     mamba2_130m (24 layers, dense per-slot SSM state) and zamba2_7b
     (cut to 15 layers; paged at FIT KV widths) each through the main
     path (report peak within 1.3 x params + 2 GB, W8/W4 QTensors,
     Poisson serving, alone == batched); on zamba2_7b's params 16-bit
     pages == the dense cache and tp=2 on one card == tp=1; state bytes
     a slot; last, a decode step of each under the profiler (launches
     and device ms a step);
  4. print the kernels line and the main-path metrics;
  5. print {"ok": true, "device": {...}} as the last line.

Writes the full measurement table to chiprun_out/chip_smoke.json.
Imports torch and the port only.
"""
from __future__ import annotations

import argparse
import contextlib
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
FP32_FLOPS = 67e12              # H100 SXM published peak, CUDA cores (dense)
# the card's HBM bytes/s and int8 / bf16 tensor-core peaks: the cost
# model's machine balance (repro_torch.obs.perf.cost), bound by main()
# once the checkout's src/ is on the path, so the kernel bounds here and
# the cost model cannot disagree
HBM_BYTES_PER_S = INT8_OPS = BF16_FLOPS = None


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
    Python wrapper's launch latency. The flush writes 128 MB, so the call
    finds up to 50 MB of dirty lines in L2 that its own reads evict to
    HBM; ``read_flush`` sums the buffer instead, leaving clean lines."""

    def __init__(self, reps: int = 10, read_flush: bool = False):
        self.reps = reps
        self.read_flush = read_flush
        self.flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(self.reps):
            if self.read_flush:
                self.flush.sum(dtype=torch.int64)
            else:
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

# the (1, N) rows the main paths' weight traces give the kernel, one
# block and one sample at a time: minitron_4b's embedding/head
# (256000 x 3072), llama3_8b's (128256 x 4096), zamba2_7b's wz/wx/out_proj
# (3584 x 7168), a Mamba2 conv weight in fp32 (4 x 7424), a norm's scale
EF_PATH_ROWS = (786_432_000, 525_336_576, 25_690_112, 2048)
EF_PATH_ROWS_F32 = (29_696,)
# an activation tap as ef_trace_activations reduces it on phase 3b's
# internlm2_1_8b path: the k / v site of 4 x 128 tokens, (B, S·KV·Dh) bf16
EF_TAP_ROWS = ((4, 128 * 8 * 128),)
# the scalar route: N % 8 != 0, so every row but the first starts off a
# 16-byte boundary
EF_SCALAR_ROWS = ((4, 1_000_003),)


def check_ef_sqnorm(timer, gen, rows):
    """Every row against the plain version (rtol 1e-4); each call one
    launch that allocates its output and, where the plan splits the row,
    the partials, nothing else; two calls the same bits; (4, N) rows equal
    four (1, N) calls (``torch.equal``). Records each row's plan, and its
    time after a read flush beside the write flush's (L2's write-back)."""
    from repro_torch.kernels import ef_sqnorm as kmod, ref

    clean = Timer(timer.reps, read_flush=True)

    def check(g, label):
        b, n = g.shape
        plan = kmod.launch_plan(n, g.dtype, g.data_ptr() % 16 == 0)
        first = kmod.ef_sqnorm(g)       # makes the ticket buffer, once
        got, launched, allocs, nbytes = count_call(
            lambda: kmod.ef_sqnorm(g), [lambda: kmod.launches])
        want = ref.ef_sqnorm(g)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=1e-4, atol=0):
            raise AssertionError(f"ef_sqnorm {label}: {got} vs {want}")
        if not torch.equal(first, got):
            raise AssertionError(f"ef_sqnorm {label}: two runs differ, "
                                 f"{first} != {got}")
        need = 4 * b + (4 * b * plan.ctas if plan.ctas > 1 else 0)
        if launched != (1,) or allocs != (1 if plan.ctas == 1 else 2) \
                or not need <= nbytes < need + 1024:
            raise AssertionError(f"ef_sqnorm {label}: {launched[0]} launches, "
                                 f"{allocs} allocations of {nbytes} B for "
                                 f"plan {tuple(plan)}")
        b_ms, b_by = bound_ms(b * n * g.element_size() + 4 * b, 2 * b * n,
                              FP32_FLOPS)
        dt = "bf16" if g.dtype == torch.bfloat16 else "fp32"
        row = {"kernel": "ef_sqnorm", "shape": f"{label} {dt}",
               "max_abs_err": err,
               "rel_err": (err / want.abs().max().item()),
               "ms": timer(lambda: kmod.ef_sqnorm(g)),
               "plain_ms": timer(lambda: ref.ef_sqnorm(g)),
               "library_ms": timer(lambda: g.float().square().sum(1)),
               "ms_read_flush": clean(lambda: kmod.ef_sqnorm(g)),
               "library_ms_read_flush": clean(lambda: g.float().square().sum(1)),
               "bound_ms": b_ms, "bound_by": b_by, "plan": plan._asdict(),
               "launches_a_call": launched[0], "allocations": allocs,
               "allocated_bytes": nbytes}
        rows.append(row)
        log(json.dumps(row))
        if b > 1:
            # a (1, N) row has the bits of that row of the (B, N) call: the
            # per-leaf reduction gives the traces the batched one gave
            alone = torch.cat([kmod.ef_sqnorm(g[i:i + 1]) for i in range(b)])
            if not torch.equal(alone, got):
                raise AssertionError(f"ef_sqnorm {label}: {b} (1, N) calls "
                                     f"{alone} != one (B, N) call {got}")
        return got

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).mul_(1e-3).to(dtype)

    for n in (16_777_216, 189_530_112):        # mlp block; embed/head block
        check(randn((4, n)), f"(4, {n})")
    for n in EF_PATH_ROWS:
        check(randn((1, n)), f"(1, {n})")
    for n in EF_PATH_ROWS_F32:
        check(randn((1, n), torch.float32), f"(1, {n})")
    for shape in EF_TAP_ROWS:
        check(randn(shape), f"{shape} KV tap")
    for shape in EF_SCALAR_ROWS:
        g = randn(shape)
        if kmod.launch_plan(shape[1], g.dtype, True).vec != 1:
            raise AssertionError(f"ef_sqnorm {shape}: not the scalar route")
        check(g, f"{shape} scalar")


QMM_SHAPES = [("wq/wo", 2048, 2048), ("wk/wv", 2048, 1024),
              ("w_up/w_gate", 2048, 8192), ("w_down", 8192, 2048),
              ("head", 2048, 92544)]
# the rest of the dense family's main paths: llama3_8b's head (128,256
# columns) and w_down (K = 14336, 112 groups: a two-pass fold),
# minitron_4b's 256,000-wide head (24 groups) and w_down (72 groups),
# phi3_mini_3_8b's head (24 groups, 32,064 columns)
QMM_PATH_SHAPES = [("llama3 head", 4096, 128256), ("llama3 w_down", 14336, 4096),
                   ("minitron head", 3072, 256000), ("minitron w_down", 9216, 3072),
                   ("phi3 head", 3072, 32064)]
# the recurrent families' projections (phase 3j): mamba2_130m's wdt (N =
# 24, less than one 32-column tile), wB/wC and out_proj; zamba2_7b's
# wB/wC (N = 64), wdt (N = 112), wz/wx, out_proj (56 groups), and the
# tp=2 column shards of its wdt (N = 56) and wB/wC (N = 32)
QMM_RECURRENT_SHAPES = [("mamba2 wdt", 768, 24), ("mamba2 wB/wC", 768, 128),
                        ("mamba2 out_proj", 1536, 768),
                        ("zamba2 wB/wC", 3584, 64), ("zamba2 wdt", 3584, 112),
                        ("zamba2 wz/wx", 3584, 7168),
                        ("zamba2 out_proj", 7168, 3584),
                        ("zamba2 wdt tp=2 shard", 3584, 56),
                        ("zamba2 wB/wC tp=2 shard", 3584, 32)]


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


def check_qmm(timer, gen, rows, shapes=QMM_SHAPES, widths=(8, 6, 4, 3),
              ms=(1, 4)):
    """qmm against its plain version (terms ``torch.equal``, the output
    within 1e-5) and its one-launch contract."""
    from repro_torch.kernels import qmm as kmod, ref
    from repro_torch.qtensor import quantize

    for name, k, n in shapes:
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        for bits in widths:
            qt = quantize(w, bits, group_size=128)
            wd = qt.dequantize(torch.bfloat16)
            for m in ms:
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
# than a CTA's pass holds, so the fold runs in two passes) and its Mamba2
# out_proj (G=56, row-parallel at tp=2 in phase 3j); and a group of
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
                     ("zamba2 out_proj", 7168, 3584, 8, 1, 128),
                     ("zamba2 out_proj", 7168, 3584, 4, 4, 128),
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
# deepseek_moe_16b's expert projections (64 experts, d_ff 1408): N = 1408
# (11 column tiles of 128) and K = 1408 (11 groups)
DEEPSEEK_GROUPED_SHAPES = [("deepseek w_up/w_gate", 2048, 1408, 128),
                           ("deepseek w_down", 1408, 2048, 128)]
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


def check_grouped_qmm(timer, gen, rows, shapes=GROUPED_SHAPES,
                      widths=(8, 6, 4, 3), caps=GROUPED_CAPS):
    from repro_torch.kernels import grouped_qmm as kmod, qmm as kqmm, ref
    from repro_torch.qtensor import expert_slice, quantize_experts

    s = N_EXPERTS
    for name, k, n, gsize in shapes:
        w = torch.randn((s, k, n), generator=gen, device="cuda") / k ** 0.5
        for bits in widths:
            qt = quantize_experts(w, bits, group_size=gsize)
            wd = qt.dequantize(torch.bfloat16)
            for c in caps:
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
          # the dense family's GQA: llama3_8b G = 4 over 8 kv heads,
          # minitron_4b G = 3 (not a power of two), phi3_mini_3_8b G = 1 at
          # Dh = 96 over 32 kv heads
          ("paged_attention", check_paged_attention,
           {"kvh": 8, "g": 4, "widths": (8, 4, 16)}),
          ("paged_attention", check_paged_attention,
           {"kvh": 8, "g": 3, "widths": (8, 4, 16)}),
          ("paged_attention", check_paged_attention,
           {"kvh": 32, "g": 1, "dh": 96, "widths": (8, 4, 16)}),
          # zamba2_7b's shared attention: G = 1 at Dh = 112 (seven 16-value
          # chunks a row) over 32 kv heads
          ("paged_attention", check_paged_attention,
           {"kvh": 32, "g": 1, "dh": 112, "widths": (8, 4, 16)}),
          ("qmm", check_qmm, {}),
          ("qmm", check_qmm, {"shapes": QMM_PATH_SHAPES, "widths": (8, 4),
                              "ms": (4,)}),
          ("qmm", check_qmm, {"shapes": QMM_RECURRENT_SHAPES, "widths": (8, 4),
                              "ms": (1, 4)}),
          ("qmm_groups", check_qmm_groups, {}),
          ("grouped_qmm", check_grouped_qmm, {}),
          ("grouped_qmm", check_grouped_qmm,
           {"shapes": DEEPSEEK_GROUPED_SHAPES, "widths": (8, 4), "caps": (1, 20)}),
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
    from repro_torch.obs.perf import cost

    global HBM_BYTES_PER_S, INT8_OPS, BF16_FLOPS
    HBM_BYTES_PER_S, INT8_OPS, BF16_FLOPS = (cost.HBM_BW, cost.INT8_OPS,
                                             cost.PEAK_FLOPS)  # fp16 the same

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
        for arch, *path_args in MAIN_PATHS:
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            result["main_paths"][arch], keep = main_path(arch, *path_args)
            if arch in REUSED_PATHS:
                # parked on the host while the next path measures its memory
                keep["qparams"] = tree_to(keep["qparams"], "cpu")
                kept[arch] = keep
            del keep
            mp = result["main_paths"][arch]
            mp["wall_s"] = time.perf_counter() - t0
            log(f"phase 3b: {arch} main path in {mp['wall_s']:.1f} s, report "
                f"peak {mp['report_peak_mem_gb']:.2f} GB for "
                f"{mp['param_bytes'] / 1e9:.2f} GB of params, peak device "
                f"memory {mp['peak_mem_gb']:.1f} GB")
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
        log(f"phase 3g: sampled and speculative serving in "
            f"{time.perf_counter() - t0:.1f} s")
        log(json.dumps({"spec_path": spp}))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        result["obs_path"] = op = obs_path(kept)
        del kept
        log(f"phase 3i: observability in {time.perf_counter() - t0:.1f} s")
        log(json.dumps({"obs_path": op}))
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
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        result["hessian_path"] = hp = hessian_path()
        log(f"phase 3h: FIT against the Hessian in {time.perf_counter() - t0:.1f} s")
        log(json.dumps({"hessian_path": hp}))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        result["recurrent_path"] = rp = recurrent_path()
        log(f"phase 3j: the recurrent families in {time.perf_counter() - t0:.1f} s")
        log(json.dumps({"recurrent_path": rp}))

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    if args.kernels_only:
        return 0
    mps = result["main_paths"]
    paths = ([mp["launches"] for mp in mps.values()]
             + [tpp["launches"], spp["launches"], op["launches"],
                cp["launches"], lp["launches"], tp["launches"], hp["launches"]]
             + list(rp["launches"].values()))
    log(json.dumps({"kernels": kernels_line(rows, paths)}))
    for arch, mp in mps.items():
        log(f"[{card}] {arch} ({mp['layers']} layers): report "
            f"{mp['report_s']:.2f} s, report_peak_mem_gb "
            f"{mp['report_peak_mem_gb']:.2f} beside param_bytes "
            f"{mp['param_bytes'] / 1e9:.2f} GB; packed weights "
            f"{mp['packed_bytes'] / 1e9:.3f} GB vs FIT-predicted "
            f"{mp['predicted_bytes'] / 1e9:.3f} GB; decode "
            f"{mp['decode_tokens_per_s']:.1f} tok/s; TTFT p50 "
            f"{mp['ttft_p50']:.3f} s p95 {mp['ttft_p95']:.3f} s; peak "
            f"{mp['peak_mem_gb']:.1f} GB; path {mp['wall_s']:.1f} s")
    dpr = mps[DP_REPORT_ARCH]["dp_report"]
    log(f"[{card}] {DP_REPORT_ARCH} report on a 2-shard mesh (one card): "
        f"{dpr['report_s']:.2f} s, max rel err vs no mesh {dpr['max_rel_err']:.2e}")
    extra = {a: mp for a, mp in mps.items() if "step_before_profile" in mp}
    ab = tpp["step_ab"]["median_ms"]
    log(f"[{card}] decode step at batch 4, in turns: plain {ab['plain']:.1f} ms, "
        f"tp=1 mesh {ab['tp=1 mesh']:.1f} ms, tp=2 on one card {ab['tp=2']:.1f} ms")
    log(f"[{card}] plain decode step at batch 4 through the run, ms: " + ", ".join(
        f"{arch} 3b {mp['step_before_profile']['median_ms']['plain']:.1f} before "
        f"/ {mp['step_after_empty_profile']['median_ms']['plain']:.1f} after an "
        f"empty / {mp['step_after_profile']['median_ms']['plain']:.1f} after its "
        "serving profile" for arch, mp in extra.items())
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
    sc, ov = op["sync_calls"], op["overhead"]
    log(f"[{card}] 3i obs serve (internlm2_1_8b, {OBS_REQUESTS} of 3b's requests): "
        f"streams == 3b's; counters == bookkeeping ({op['parity']}); "
        f"{sc['drains']} drains, {1e3 * op['drain_s'] / sc['drains']:.3f} ms "
        f"each; synchronizing calls obs {sc['obs']} vs off {sc['off']}; "
        f"{op['trace_events']} trace events")
    log(f"[{card}] 3i counters on the other routes == bookkeeping and "
        f"launches: olmoe_1b_7b (grouped_qmm; {op['routes']['olmoe_dropped_tokens']:.0f}"
        f" MoE drops) and int8-backed W8 (int8_matmul)")
    log(f"[{card}] 3i decode step at batch 4 in turns, ms: " + ", ".join(
        f"{n} {v:.1f}" for n, v in ov["median_step_ms"].items())
        + "; served, ms a step: " + ", ".join(
            f"{n} {v:.1f}" for n, v in ov["median_serve_ms"].items())
        + f"; full-profiling drain {ov['drain_ms']:.3f} ms; syncs added by "
        f"line {sc['added_by_line']}")
    dr = op["drift"]
    log(f"[{card}] 3i drift ({OBS_DRIFT_LAYERS} layers): calibrated "
        f"max ratio {dr['calibrated']['max_ratio']:.2f}, kl mean "
        f"{dr['calibrated']['kl_mean']:.3g}; 3x stale: "
        f"{dr['stale_3x']['n_flagged']} sites flagged in "
        f"{dr['stale_3x']['flagged_layers']}")
    log(f"[{card}] 3i profile CLI: {op['profile_cli']['sites']} sites, "
        f"{op['profile_cli']['wall_s']:.1f} s; phase 3i seconds: " + ", ".join(
            f"{k} {v:.1f}" for k, v in op["seconds"].items()))
    log(f"[{card}] launch.serve internlm2_1_8b --int8 --int8-compute --paged "
        f"({cp['layers']} layers): int8-backed weights "
        f"{cp['weight_bytes'] / 1e9:.3f} GB; decode "
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
    log(f"[{card}] 3h {hp['arch']} ({hp['layers']} layers, batch "
        f"{hp['batch']}x{hp['seq']}): EF traces {hp['ef_s']:.2f} s, "
        f"Hutchinson ({hp['probes']} probes, fp32) {hp['hutchinson_s']:.2f} s; "
        f"Spearman of the {hp['blocks']} per-block traces "
        f"{hp['spearman']:.4f}")
    log_recurrent(card, rp)
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def log_recurrent(card: str, rp: dict) -> None:
    """Phase 3j's summary lines."""
    for arch, mp in rp["paths"].items():
        st, sb = mp["step"], mp["state_bytes_per_slot"]
        log(f"[{card}] 3j {arch} ({mp['layers']} layers): report "
            f"{mp['report_s']:.2f} s, report_peak_mem_gb "
            f"{mp['report_peak_mem_gb']:.2f} beside param_bytes "
            f"{mp['param_bytes'] / 1e9:.2f} GB; packed weights "
            f"{mp['packed_bytes'] / 1e9:.3f} GB vs FIT-predicted "
            f"{mp['predicted_bytes'] / 1e9:.3f} GB; KV widths "
            f"{mp['kv_bits'] or 'none'}; decode {mp['decode_tokens_per_s']:.1f} "
            f"tok/s, {mp['decode_ms_per_step']:.1f} ms a step; TTFT p50 "
            f"{mp['ttft_p50']:.3f} s p95 {mp['ttft_p95']:.3f} s; state a slot "
            f"{sb['h'] / 1e6:.1f} MB h + {sb['conv'] / 1e6:.2f} MB conv, KV pool "
            f"{(mp['kv_pool_bytes'] or 0) / 1e6:.1f} MB; step at batch "
            f"{st['batch']}: "
            f"{st['launches_per_step']:.0f} launches, host "
            f"{st['host_ms_per_step']:.1f} ms, device "
            f"{st['device_ms_per_step']:.2f} ms; peak {mp['peak_mem_gb']:.1f} GB")
    t2 = rp["tp2"]
    log(f"[{card}] 3j zamba2_7b tp=2 on one card == tp=1 ({t2['blocks']} blocks, "
        f"{t2['kv_shards']} kv shards): decode {t2['decode_tokens_per_s']:.1f} "
        f"tok/s, {t2['decode_ms_per_step']:.1f} ms a step; 16-bit pages == "
        f"dense cache over {rp['paged_equals_dense']['tokens']} tokens; phase "
        "3j seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in rp["seconds"].items()))


KERNELS = [
    # name, source, TPU kernel it replaces, representative phase-2 row
    ("ef_sqnorm", "src/repro_torch/kernels/csrc/ef_sqnorm.cu",
     "src/repro/kernels/ef_sqnorm.py:34", "(1, 786432000) bf16"),
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
SMOKE_ARCHS = ("internlm2_1_8b", "olmoe_1b_7b", "deepseek_moe_16b", "llama3_8b",
               "phi3_mini_3_8b", "minitron_4b", "mamba2_130m", "zamba2_7b")
# full-width main paths (arch, Poisson requests, with the profiler and
# decode-step A/B extras, layers: None for full depth), driven in this
# order; phases 3f, 3g and 3i reuse the first two. Serving is paced by
# the host, one decode step's launches a layer, so a path's wall grows
# with its depth: every path but minitron is cut to PATH_LAYERS to keep
# the script near half its time limit; minitron keeps its full depth,
# where its report peak sits nearest the memory bound
PATH_LAYERS = 8
MAIN_PATHS = (("internlm2_1_8b", 8, True, PATH_LAYERS),
              ("olmoe_1b_7b", 8, True, PATH_LAYERS),
              ("llama3_8b", 8, False, PATH_LAYERS),
              ("deepseek_moe_16b", 8, False, PATH_LAYERS),
              ("phi3_mini_3_8b", 4, False, PATH_LAYERS),
              ("minitron_4b", 4, False, None))
REUSED_PATHS = ("internlm2_1_8b", "olmoe_1b_7b")


@contextlib.contextmanager
def cut_depth(module, layers: int):
    """``module.get_config`` returns its configs cut to ``layers`` (full
    width) inside the block: the entry points that look a config up by
    name (``launch.serve.serve``, ``launch.train.train``) run cut."""
    full = module.get_config
    module.get_config = lambda name: dataclasses.replace(full(name),
                                                         num_layers=layers)
    try:
        yield
    finally:
        module.get_config = full
# the data-parallel report: this path's report again on a two-shard mesh
DP_REPORT_ARCH = "internlm2_1_8b"
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
                "spec_int8": ("int8_matmul", "paged_attention"),
                # phase 3h: the FIT report's EF traces beside Hutchinson
                "hessian": ("ef_sqnorm",),
                # phase 3j: the recurrent families, and the hybrid at tp=2
                "ssm": ("ef_sqnorm", "qmm"),
                "hybrid": ("ef_sqnorm", "qmm", "paged_attention"),
                "hybrid_tp": ("qmm_groups", "qmm", "paged_attention"),
                # phase 3i: obs-enabled serving, by route
                "obs": ("qmm", "paged_attention"),
                "obs_moe": ("qmm", "grouped_qmm", "paged_attention"),
                "obs_int8": ("int8_matmul", "paged_attention")}
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
    """The packed paged decode path (a dense state for the ssm family,
    which holds no KV) on the card against the same path on the CPU
    (plain versions) at a smoke config: per-step logits agree.
    Tolerance 2e-2 absolute on logits of size ~1: fp32 sums run in
    another order, so a value at a rounding boundary may land one grid
    step apart in an activation's per-row int8 grid or in a 4-bit KV
    page, which moves a logit by a few 1e-3."""
    from repro_torch.configs import smoke_config
    from repro_torch.kvcache.paged import PagedKVConfig, kv_layer_count
    from repro_torch.models.context import DequantContext
    from repro_torch.models.decode import (
        decode_step, init_decode_state, init_paged_decode_state)
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.quantized import quantize_params

    cfg = smoke_config(arch)
    n_kv = kv_layer_count(cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, seed=0, device="cpu")
        qp, _ = quantize_params(params, 4, group_size=16, device=dev)
        if n_kv:
            pc = PagedKVConfig.build(cfg, 32, 2, page_size=8, kv_bits={
                i: (8, 4)[i % 2] for i in range(n_kv)})
            st = init_paged_decode_state(cfg, pc, 2, device=dev)
            st.paged.table.copy_(torch.arange(8, dtype=torch.int32).reshape(2, 4))
            st.paged.write_limit.fill_(32)
        else:
            st = init_decode_state(cfg, 2, 32, device=dev)
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


def main_path(arch: str, n_requests: int = 8, extras: bool = True,
              layers=None, prompt_len=(16, 64)):
    """One full-width main path; returns its metrics and what phase 3f
    needs to serve the same requests sharded. Every kernel counter is set
    to 0 at the start and read right after the serving run. The report's
    peak memory must stay within 1.3 x the parameter bytes + 2 GB (the
    per-sample gradient tree never exists whole). ``extras``: the
    decode-step A/B around the first profiler sessions and the serving
    profile. ``layers``: the depth, if cut (full width all the same);
    ``prompt_len``: the requests' prompt range (each prompt token is one
    host-paced decode step). A
    family that holds no KV (ssm) serves from the dense per-slot state,
    with neither KV taps in its report nor FIT KV widths."""
    from repro_torch.configs import get_config
    from repro_torch.core.report import build_report
    from repro_torch.launch.mesh import TPMesh
    from repro_torch.utils.pytree import tree_bytes
    from repro_torch.data.synthetic import LMStreamConfig, lm_batches
    from repro_torch.kvcache.fit import allocate_kv_bits, kv_report_fns
    from repro_torch.kvcache.paged import dense_kv_bytes, kv_layer_count
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.qtensor import storage_summary
    from repro_torch.quant.policy import QuantPolicy
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.loadgen import poisson_requests
    from repro_torch.serve.quantized import bit_config_from_report, quantize_params

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    res = {"arch": arch, "layers": cfg.num_layers}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    res["param_bytes"] = tree_bytes(params)
    # the init's own peak holds fp32 temporaries of the embedding and
    # the head; the report's is measured apart from it
    res["init_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    stream = lm_batches(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                       global_batch=4, seed=0))
    batches = [next(stream) for _ in range(2)]
    paged = kv_layer_count(cfg) > 0
    tap_loss, tap_shapes, act_fn = kv_report_fns(cfg) if paged else (None,) * 3

    def report_on(mesh=None):
        return build_report(lambda p, b: loss_fn(p, b, cfg), tap_loss,
                            tap_shapes and (lambda b: tap_shapes(params, b)),
                            act_fn, params, batches, tolerance=None,
                            max_batches=2, mesh=mesh)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = report_on()
    torch.cuda.synchronize()
    res["report_s"] = time.perf_counter() - t0
    res["report_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    limit = 1.3 * res["param_bytes"] / 1e9 + 2.0
    if res["report_peak_mem_gb"] > limit:
        raise AssertionError(f"{arch} report peak {res['report_peak_mem_gb']:.2f} "
                             f"GB > 1.3 x params + 2 GB = {limit:.2f} GB")
    traces = list(report.weight_traces.values()) + list(report.act_traces.values())
    if not all(math.isfinite(t) and t > 0 for t in traces):
        raise AssertionError("non-finite or non-positive EF trace")
    res["n_weight_blocks"] = len(report.weight_traces)
    res["n_act_sites"] = len(report.act_traces)
    if arch == DP_REPORT_ARCH:
        # the data-parallel mode: the batch in two shards on this card,
        # per-block sums added in shard order
        t0 = time.perf_counter()
        dp = report_on(TPMesh([torch.device("cuda", 0)] * 2))
        torch.cuda.synchronize()
        err = max(abs(dp.weight_traces[k] - v) / abs(v)
                  for k, v in report.weight_traces.items())
        if list(dp.weight_traces) != list(report.weight_traces) or err > 1e-5:
            raise AssertionError(f"{arch} report on a 2-shard mesh differs from "
                                 f"the report without one (max rel err {err})")
        res["dp_report"] = {"shards": 2, "report_s": time.perf_counter() - t0,
                            "max_rel_err": err}

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
                        prefill_chunk=32, page_size=16,
                        kv_cache="paged" if paged else "dense",
                        int8_compute=True, prefix_sharing=False, clock="wall")
    kv_bits = None
    if paged:
        kv_elems = dense_kv_bytes(cfg, ecfg.max_slots, ecfg.max_len, bits=8)
        kv_bits = allocate_kv_bits(report, cfg, QuantPolicy(),
                                   6.0 / 8.0 * kv_elems,
                                   tokens=ecfg.max_slots * ecfg.max_len)
    res["kv_bits"] = {str(k): v for k, v in (kv_bits or {}).items()}
    engine = Engine(qparams, cfg, ecfg, kv_bits=kv_bits,
                    kv_ranges=report.act_ranges)

    def requests():
        return poisson_requests(cfg, n_requests, rate=4.0, prompt_len=prompt_len,
                                gen_len=(8, 32), seed=1)

    t0 = time.perf_counter()
    fin, metrics = engine.run(requests())
    torch.cuda.synchronize()
    res["serve_s"] = time.perf_counter() - t0
    res["launches"] = read_counts()
    if len(fin) != n_requests:
        raise AssertionError(f"{len(fin)} of {n_requests} requests finished")
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
        for rid in (0, n_requests - 3):
            alone = [r for r in requests() if r.id == rid]
            alone[0].arrival_time = 0.0
            got, _ = engine.run(alone)
            if not (got[0].output_tokens == fin[rid].output_tokens).all():
                raise AssertionError(f"request {rid}: alone != batched")
    if extras:
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
    res["decode_ms_per_step"] = 1e3 * metrics.decode_s / max(metrics.decode_steps, 1)
    # the peak counter was reset before and after the report
    res["peak_mem_gb"] = max(res["init_peak_mem_gb"], res["report_peak_mem_gb"],
                             torch.cuda.max_memory_allocated() / 1e9)
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
      * ``launch.serve.serve()`` at full width and ``PATH_LAYERS`` layers
        with int8-backed W8 through int8_matmul, sampled, ``spec_k=4, spec_kv_bits=4``: streams equal
        the same engine's plain run; then the CLI itself at smoke size in
        a subprocess with ``--spec-k 4 --spec-kv-bits 4 --temperature
        0.8``;
      * the sampler's cost: a decode step with the full sampler against a
        greedy one, in turns (``sampler_ab``)."""
    from repro_torch.core.fit import allocate_draft_bits
    from repro_torch.launch.mesh import TPMesh
    from repro_torch.launch import serve as smod
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
    with cut_depth(smod, PATH_LAYERS):
        out = smod.serve("internlm2_1_8b", False, 4, 16, 16, 8, int8=True,
                         int8_compute=True, n_requests=4, rate=4.0,
                         paged=True, page_size=16, kv_bits=8, spec_k=SPEC_K,
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
    --page-size 16 --kv-bits 8 --shared-prefix 24``) at full width and
    ``PATH_LAYERS`` layers. The prefix ends inside a page, so admission
    shares a full page and copies the boundary page on write."""
    from repro_torch.launch import serve as smod

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with cut_depth(smod, PATH_LAYERS):
        out = smod.serve("internlm2_1_8b", False, 4, 64, 32, 8, int8=True,
                         int8_compute=True, n_requests=8, rate=4.0,
                         clock="wall", paged=True, page_size=16, kv_bits=8,
                         shared_prefix=24)
    torch.cuda.synchronize()
    res = {"serve_s": time.perf_counter() - t0, "launches": read_counts()}
    engine = out["engine"]
    cfg = engine.cfg
    res["layers"] = cfg.num_layers
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
    tmp = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        with cut_depth(tmod, 2):
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


OBS_REQUESTS = 4        # phase 3i: the 4 shortest of 3b's internlm2 requests
OBS_DRIFT_LAYERS = 4    # depth of phase 3i's drift model (full width)


def _sync_calls(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: the
    number of synchronizing CUDA calls it made (one warning each), and
    the count by the source line that made each."""
    import collections
    import linecache
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    hits = [w for w in caught if "synchroniz" in str(w.message)]
    where = collections.Counter(
        f"{Path(w.filename).parent.name}/{Path(w.filename).name}:{w.lineno} "
        + linecache.getline(w.filename, w.lineno).strip() for w in hits)
    return len(hits), dict(where)


def obs_path(kept: dict) -> dict:
    """Phase 3i: observability on phase 3b's internlm2_1_8b params (run
    right after 3g), the engine on the step clock so two runs schedule
    alike. Counters set to 0 just before the observed run, read after.

      * obs changes no token: the 4 shortest of 3b's requests served with
        ``ObsConfig(trace, device_metrics, perf, drain_every=2)``
        ``torch.equal`` 3b's streams;
      * counter parity: the drained totals equal the host bookkeeping
        (tokens, steps, the histogram summed to the bursts), ``qmm_calls``
        and ``paged_calls`` the kernels' launches inside the bursts (the
        window the counter sinks cover), and there were >= 2 drains; the
        same on olmoe_1b_7b (``grouped_qmm``) and the int8-backed route
        (``int8_matmul``);
      * zero sync: that run and an obs-off run of the same requests under
        ``set_sync_debug_mode("warn")``: obs adds at most one
        synchronizing call a drain, plus one;
      * the Chrome trace validates with its device track; every dispatch's
        CUDA-event time is at most its host wall;
      * drift at full width and 4 layers: calibrated, quiet; calibration
        3x stale, sites flagged by layer;
      * ``python -m repro_torch.launch.profile --smoke`` in a subprocess:
        its JSON and trace, every site's predicted bytes those of the
        same packed tree's cost model, whose weight bytes equal
        ``storage_summary``'s packed bytes;
      * the decode step with obs off, counters, counters with clip
        statistics every burst and full profiling, in turns (printed, no
        gate: the host's spread exceeds them)."""
    from repro_torch.obs import (
        GAUGE_HELP, ObsConfig, parse, render, snapshot, validate_chrome_trace)
    from repro_torch.serve.engine import Engine

    res = {"seconds": {}, "launches": {}}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        res["seconds"][name] = now - clock[0]
        clock[0] = now

    k = kept["internlm2_1_8b"]
    cfg = k["cfg"]
    ecfg = dataclasses.replace(k["ecfg"], clock="steps")
    qp = tree_to(k["qparams"], "cuda")          # shared by every engine below
    kw = dict(kv_bits=k["kv_bits"], kv_ranges=k["ranges"])
    ids = sorted(r.id for r in sorted(
        k["requests"](), key=lambda r: r.prompt_len + r.max_new_tokens
    )[:OBS_REQUESTS])

    def requests():
        return [r for r in k["requests"]() if r.id in ids]

    full = ObsConfig(trace=True, device_metrics=True, perf=True, drain_every=2)
    eng = Engine(qp, cfg, dataclasses.replace(ecfg, obs=full), **kw)
    out = {}
    syncs_on, where_on = _sync_calls(
        lambda: out.update(observed_run(res, "obs", eng, requests())))
    want = {i: k["streams"][i] for i in ids}
    if out["streams"] != want:
        raise AssertionError(f"3i: obs changed the streams: {out['streams']} "
                             f"vs {want}")
    res.update(counters=eng.counters.totals(), rates=eng.counters.rates(),
               parity=out["parity"], n_drains=eng.counters.n_drains,
               drain_s=eng.counters.drain_s, timing=eng.perf.summary())
    m = eng.metrics
    lap("observed serve")

    off = Engine(qp, cfg, ecfg, **kw)
    # the observed run's synchronize() calls, around the same work
    syncs_off, where_off = _sync_calls(lambda: (torch.cuda.synchronize(),
                                                off.run(requests()),
                                                torch.cuda.synchronize()))
    res["sync_calls"] = {"obs": syncs_on, "off": syncs_off,
                         "drains": eng.counters.n_drains,
                         "added_by_line": {k: v - where_off.get(k, 0)
                                           for k, v in where_on.items()
                                           if v != where_off.get(k, 0)}}
    if syncs_on - syncs_off > eng.counters.n_drains + 1:
        raise AssertionError(f"3i: obs added synchronizing calls: {res['sync_calls']}")
    lap("obs-off serve")

    trace = eng.tracer.chrome_trace()
    problems = validate_chrome_trace(trace)
    dev = [e for e in trace["traceEvents"]
           if e.get("cat") == "device" and e.get("ph") == "X"]
    if problems or not dev:
        raise AssertionError(f"3i trace: {problems[:3]}, {len(dev)} device spans")
    res["trace_events"] = eng.tracer.n_events
    text = render(snapshot(eng), GAUGE_HELP)
    if parse(text)[("repro_ctr_decode_tokens", "")] != m.decode_tokens:
        raise AssertionError("3i: the Prometheus snapshot's decode tokens")
    res["snapshot_lines"] = len(text.splitlines())
    for kind in ("prefill_chunk", "decode_burst"):
        st = res["timing"][kind]
        if st["device_timed"] != st["count"] or st["device_over_wall_max"] > 1.0:
            raise AssertionError(f"3i {kind} timing: {st}")
    del eng, off
    lap("trace checks")

    res["routes"] = obs_routes(res, kept)
    lap("MoE and int8 routes")
    res["drift"] = drift_check()
    lap("drift")
    res["profile_cli"] = run_profile_cli_smoke()
    lap("profile CLI")
    res["overhead"] = obs_overhead(qp, cfg, ecfg, kw)
    lap("overhead in turns")
    return res


def observed_run(res: dict, path: str, engine, reqs) -> dict:
    """Serve ``reqs`` on an obs engine with every kernel counter set to 0
    just before and read just after (added to ``res["launches"]``); the
    drained totals must equal the host bookkeeping, and each call count
    the launches of its kernels inside ``engine._burst`` (the window the
    counter sinks cover). Returns the parity pairs and the streams by
    request id."""
    from repro_torch.kernels import grouped_qmm as kg
    from repro_torch.kernels import int8_matmul as ki
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import qmm as kqmm

    window = {"qmm": 0, "int8mm": 0, "paged": 0}
    burst = engine._burst

    def counted(steps):
        q0, i0, p0 = kqmm.launches + kg.launches, ki.launches, kpa.launches
        burst(steps)
        window["qmm"] += kqmm.launches + kg.launches - q0
        window["int8mm"] += ki.launches - i0
        window["paged"] += kpa.launches - p0

    engine._burst = counted
    torch.cuda.synchronize()
    reset_counts()
    fin, m = engine.run(reqs)
    torch.cuda.synchronize()
    launches = read_counts()
    for name, v in launches.items():
        res["launches"][name] = res["launches"].get(name, 0) + v
    for name in PATH_KERNELS[path]:
        if launches[name] <= 0:
            raise AssertionError(f"3i {path}: kernel {name} was not launched")
    t = engine.counters.totals()
    parity = {"decode_tokens": (t["decode_tokens"], m.decode_tokens),
              "decode_steps": (t["decode_steps"], m.decode_steps),
              "hist_sum": (sum(t["burst_size_hist"]), t["decode_bursts"]),
              "qmm_calls": (t["qmm_calls"], window["qmm"]),
              "int8mm_calls": (t["int8mm_calls"], window["int8mm"]),
              "paged_calls": (t["paged_calls"], window["paged"])}
    if (any(a != b for a, b in parity.values()) or engine.counters.n_drains < 2
            or not 0.0 <= t["act_sat"] <= t["act_elems"]):
        raise AssertionError(f"3i {path} counter parity: {parity}, "
                             f"{engine.counters.n_drains} drains, {t}")
    return {"parity": parity,
            "streams": {r.id: r.output_tokens.tolist() for r in fin}}


def obs_routes(res: dict, kept: dict) -> dict:
    """The counters on the other serving routes: olmoe_1b_7b at full width
    on 3b's params (``grouped_qmm``; its MoE drops) and the int8-backed
    W8 route at smoke size (``int8_matmul``), clip statistics every
    burst."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import init_params
    from repro_torch.obs import ObsConfig
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.loadgen import poisson_requests
    from repro_torch.serve.quantized import quantize_params_int8

    obs = ObsConfig(device_metrics=True, stats_every=1, drain_every=1)
    out = {}
    km = kept["olmoe_1b_7b"]
    mcfg = km["cfg"]
    eng = Engine(km["qparams"], mcfg, dataclasses.replace(
        km["ecfg"], clock="steps", obs=obs), kv_bits=km["kv_bits"],
        kv_ranges=km["ranges"])
    reqs = poisson_requests(mcfg, 3, rate=1.0, prompt_len=(8, 12), gen_len=8,
                            seed=7)
    out["olmoe"] = observed_run(res, "obs_moe", eng, reqs)["parity"]
    out["olmoe_dropped_tokens"] = eng.counters.totals()["moe_dropped_tokens"]
    del eng
    cfg = dataclasses.replace(smoke_config("internlm2_1_8b"), scan_layers=False)
    qp, scales = quantize_params_int8(init_params(cfg, seed=0), 8)
    eng = Engine(qp, cfg, EngineConfig(
        max_slots=2, max_len=32, max_new_tokens=8, prefill_chunk=8,
        decode_burst=4, int8_compute=True, kv_cache="paged", page_size=8,
        obs=obs), scales=scales, kv_bits=8)
    reqs = poisson_requests(cfg, 3, rate=1.0, prompt_len=(6, 12), gen_len=8,
                            seed=7)
    out["int8"] = observed_run(res, "obs_int8", eng, reqs)["parity"]
    return out


def drift_check() -> dict:
    """The FIT drift monitor on internlm2_1_8b at full width and
    OBS_DRIFT_LAYERS layers (W4, group 128, int8 KV): ranges calibrated on
    an fp forward over 2 batches of 4 x 128 tokens keep it quiet; the
    same run self-calibrated at 1/3 scale flags sites, grouped by layer."""
    from repro_torch.configs import get_config
    from repro_torch.core.report import to_device_batch
    from repro_torch.data.synthetic import LMStreamConfig, lm_batches
    from repro_torch.models.context import CollectContext
    from repro_torch.models.transformer import forward, init_params
    from repro_torch.obs.drift import DriftMonitor
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.loadgen import poisson_requests
    from repro_torch.serve.quantized import quantize_params

    cfg = dataclasses.replace(get_config("internlm2_1_8b"),
                              num_layers=OBS_DRIFT_LAYERS)
    params = init_params(cfg, seed=0)
    stream = lm_batches(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                       global_batch=4, seed=0))
    ranges = {}
    with torch.no_grad():
        for _ in range(2):
            ctx = CollectContext()
            forward(params, to_device_batch(next(stream), "cuda"), cfg, ctx=ctx)
            for s, a in ctx.acts.items():
                lo, hi = ranges.get(s, (0.0, 0.0))
                ranges[s] = (min(lo, float(a.min())), max(hi, float(a.max())))
    qp, _ = quantize_params(params, 4, group_size=128)
    ecfg = EngineConfig(max_slots=4, max_len=64, max_new_tokens=16,
                        prefill_chunk=16, page_size=16, kv_cache="paged",
                        int8_compute=True)
    out = {}
    for tag, rng, scale in (("calibrated", ranges, 1.0),
                            ("stale_3x", {}, 1.0 / 3.0)):
        eng = Engine(qp, cfg, ecfg, kv_bits=8, kv_ranges=ranges)
        mon = DriftMonitor(params, rng, every=4, calibration_scale=scale)
        mon.attach(eng)
        reqs = poisson_requests(cfg, 4, rate=1.0, prompt_len=(8, 16),
                                gen_len=16, seed=4)
        t0 = time.perf_counter()
        eng.run(reqs)
        rep = mon.drift_report()
        out[tag] = {"n_samples": rep["n_samples"], "kl_mean": rep["kl_mean"],
                    "kl_max": rep["kl_max"],
                    "max_ratio": max(d["max_ratio"] for d in rep["sites"].values()),
                    "flagged_layers": rep["flagged_layers"],
                    "n_flagged": len(rep["flagged_sites"]),
                    "wall_s": time.perf_counter() - t0}
        if rep["n_samples"] < 2:
            raise AssertionError(f"3i drift {tag}: {rep['n_samples']} samples")
    if not (out["calibrated"]["n_flagged"] == 0
            and out["stale_3x"]["n_flagged"] > 0
            and all(lay.startswith("layers/")
                    for lay in out["stale_3x"]["flagged_layers"])):
        raise AssertionError(f"3i drift: {out}")
    return out


def run_profile_cli_smoke() -> dict:
    """``python -m repro_torch.launch.profile --smoke`` in a subprocess on
    this card, its outputs checked by ``check_profile``."""
    import os

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    js, tr = out_dir / "profile.json", out_dir / "profile_trace.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.profile", "--arch",
           "internlm2_1_8b", "--smoke", "--weight-bits", "4", "--group-size",
           "8", "--kv-bits", "8", "--requests", "6", "--json", str(js),
           "--trace", str(tr)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"launch.profile CLI exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    return dict(check_profile(js, tr), wall_s=time.perf_counter() - t0)


def check_profile(js: Path, tr: Path) -> dict:
    """The profile CLI's outputs: its JSON parses, its trace validates with
    a device track, and every site's predicted bytes are the cost model's
    for the same packed tree (built here from the same seed), whose
    weight bytes equal ``storage_summary``'s packed bytes, site by site."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import init_params
    from repro_torch.obs import validate_chrome_trace
    from repro_torch.obs.perf import site_costs_from_tree
    from repro_torch.qtensor import storage_summary
    from repro_torch.serve.quantized import quantize_params
    from repro_torch.utils.pytree import named_leaves

    payload = json.loads(js.read_text())
    trace = json.loads(tr.read_text())
    problems = validate_chrome_trace(trace)
    if problems or not any(e.get("cat") == "device" for e in trace["traceEvents"]):
        raise AssertionError(f"launch.profile trace: {problems[:3]}")
    cfg = dataclasses.replace(smoke_config("internlm2_1_8b"), scan_layers=False)
    qp, _ = quantize_params(init_params(cfg, seed=0), 4, group_size=8)
    costs = site_costs_from_tree(qp, 2, context=24 + 12 // 2, kv_bits=8,
                                 page_size=8, cfg=cfg)
    leaves = dict(named_leaves(qp))
    for row in payload["sites"]:
        c = costs[row["site"]]
        if row["predicted_bytes"] != c.bytes:
            raise AssertionError(f"launch.profile site {row}: cost {c}")
        if c.kind == "qmm" and c.bytes_weight != \
                storage_summary([leaves[row["site"]]])["packed_bytes"]:
            raise AssertionError(f"launch.profile site {row['site']}: weight "
                                 "bytes != packed storage")
    if {r["site"] for r in payload["sites"]} != set(costs):
        raise AssertionError("launch.profile: sites differ from the cost model")
    return {"sites": len(payload["sites"]), "timing": payload["timing"],
            "roofline_step_ms": 1e3 * payload["roofline_totals"]["step_time_s"]}


def obs_overhead(qp, cfg, ecfg, kw, turns: int = 2, steps: int = 8) -> dict:
    """What observability costs, in turns, on engines sharing ``qp``:

      * the decode step at batch ``max_slots`` (host clock, ``steps``
        steps a leg ending in a synchronize, on a fresh paged state that
        maps every page) with no counter sink, a counters sink, and a
        sink that also computes the clip statistics, each sink folded
        once a leg as a burst of ``steps`` folds it;
      * ms per decode step (burst walls over steps) of 4 short requests
        (prompt 4, 17 new tokens) served with obs off and fully profiled
        (trace, counters, timed dispatches, statistics every 4th burst),
        and the full engine's ms a drain."""
    from repro_torch.models.decode import decode_step
    from repro_torch.obs import (
        CounterSink, ObsConfig, collecting, fold, init_counters)
    from repro_torch.obs.runtime import init_host_counters
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.loadgen import poisson_requests

    engines = {"off": Engine(qp, cfg, ecfg, **kw),
               "full": Engine(qp, cfg, dataclasses.replace(ecfg, obs=ObsConfig(
                   trace=True, device_metrics=True, perf=True, drain_every=4)),
                   **kw)}
    eng = engines["off"]
    s, npp = ecfg.max_slots, ecfg.max_len // ecfg.page_size
    st = eng._fresh_state()
    st.paged.table.copy_(torch.arange(s * npp, dtype=torch.int32).reshape(s, npp))
    st.paged.write_limit.fill_(ecfg.max_len)
    tok = torch.zeros((s, 1), dtype=torch.int32, device=eng.device)
    ctr, host = init_counters(eng.device), init_host_counters()
    sinks = {"off": None, "counters": CounterSink(stats=False),
             "counters+stats": CounterSink(stats=True)}

    def step_leg(name):
        nonlocal st
        sink = sinks[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(steps):
                if sink is None:
                    _, st = decode_step(eng.params, st, tok, cfg, ctx=eng._ctx)
                else:
                    with collecting(sink):
                        _, st = decode_step(eng.params, st, tok, cfg,
                                            ctx=eng._ctx)
            if sink is not None:
                fold(ctr, sink, host)         # as a burst of ``steps`` does
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / steps

    step_ms = {n: [] for n in sinks}
    step_leg("off")                                   # warm
    for name in (list(sinks) + list(sinks)[::-1]) * turns:
        step_ms[name].append(step_leg(name))
    serve_ms = {n: [] for n in engines}
    for name in ["off", "full", "full", "off"] * (turns // 2 or 1):
        reqs = poisson_requests(cfg, 4, rate=1.0, prompt_len=4, gen_len=17,
                                seed=5)
        for r in reqs:
            r.arrival_time = 0.0
        _, m = engines[name].run(reqs)
        serve_ms[name].append(1e3 * m.decode_s / max(m.decode_steps, 1))
    full = engines["full"].counters
    return {"step_ms": step_ms, "serve_ms_per_step": serve_ms,
            "median_step_ms": {n: statistics.median(v) for n, v in step_ms.items()},
            "median_serve_ms": {n: statistics.median(v)
                                for n, v in serve_ms.items()},
            "drain_ms": 1e3 * full.drain_s / max(full.n_drains, 1)}


# phase 3j: the recurrent families at full width (arch, Poisson
# requests, layers: None for full depth). zamba2_7b is cut to 15 of its
# 81 layers (two groups of 6 and a 3-layer remainder, 2 of the 13 shared
# block applications): at full depth its part of the phase took 290 s
# (a decode step 245 ms on the host, 11,740 launches), which the script's
# time limit cannot hold beside phases 2-3i. Prompts of 8-32 tokens (3b:
# 16-64): the prefill is one host-paced step a token. Every serve of the
# phase holds twice as many requests as the engine's 4 slots, so half are
# admitted into a slot a finished request used (alone == batched then
# shows a recurrent state that leaks across admissions)
RECURRENT_PATHS = (("mamba2_130m", 8, None), ("zamba2_7b", 8, 15))
RECURRENT_CONTRACT_REQUESTS = 8
RECURRENT_PROMPTS = (8, 32)


def ssm_state_bytes(cfg) -> dict:
    """Bytes of one slot's recurrent state: the fp32 SSM state h and the
    conv tails (the param dtype), every Mamba2 layer."""
    from repro_torch.models.decode import init_decode_state

    st = init_decode_state(cfg, 1, 1, device="cuda")
    parts = [p for p in (st.ssm, st.rest) if p is not None]
    return {"h": sum(p.h.numel() * p.h.element_size() for p in parts),
            "conv": sum(p.conv.numel() * p.conv.element_size() for p in parts)}


def step_profile(engine, steps: int = 4, n_top: int = 8) -> dict:
    """Where one decode step at batch ``max_slots`` goes: ``steps`` steps
    on the host clock (after one warm step), then ``steps`` more under
    torch.profiler (device activity only): every CUDA kernel counted and
    summed, on a fresh state (pages mapped for every slot)."""
    from torch.autograd import DeviceType

    from repro_torch.models.decode import decode_step

    ec = engine.ecfg
    b = ec.max_slots
    tok = torch.zeros((b, 1), dtype=torch.int32, device=engine.device)
    st = [engine._fresh_state()]
    if st[0].paged is not None:
        npp = ec.max_len // ec.page_size
        st[0].paged.table.copy_(torch.arange(b * npp, dtype=torch.int32)
                                .reshape(b, npp))
        st[0].paged.write_limit.fill_(ec.max_len)

    def run(n):
        for _ in range(n):
            _, st[0] = decode_step(engine.params, st[0], tok, engine.cfg,
                                   ctx=engine._ctx)

    with torch.no_grad():
        run(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / steps
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run(steps)
            torch.cuda.synchronize()
    per = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, ns = per.get(e.name(), (0, 0))
            per[e.name()] = (n + 1, ns + e.duration_ns())
    kernels = sum(n for n, _ in per.values())
    device_ms = sum(ns for _, ns in per.values()) / 1e6 / steps
    top = sorted(per.items(), key=lambda kv: kv[1][1], reverse=True)[:n_top]
    return {"batch": b, "steps": steps, "host_ms_per_step": host_ms,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / host_ms,
            "launches_per_step": kernels / steps,
            "top_kernels": [{"name": name[:90], "count_per_step": n / steps,
                             "device_ms_per_step": ns / 1e6 / steps}
                            for name, (n, ns) in top]}


def recurrent_path() -> dict:
    """Phase 3j: the ssm and hybrid families end to end at full width
    (``RECURRENT_PATHS``), each through ``main_path``: seeded init -> FIT
    report (peak within 1.3 x params + 2 GB) -> W8/W4 allocation ->
    packed QTensors -> serving of Poisson requests, alone == batched;
    mamba2_130m from the dense per-slot state (no KV to page), zamba2_7b
    paged at its FIT KV widths. Then, on zamba2_7b's params and 8 short
    requests arrived at once on 4 slots (the last 4 admitted into used
    slots): 16-bit pages == the dense cache, token for
    token, and tp=2 (``TPMesh([cuda:0] * 2)``: the Mamba2 and shared-block
    projections column/row-sharded, pools kv-sharded, SSM states on the
    lead device) == the tp=1 engine at the FIT KV widths, with exact
    ``qmm_groups`` launch counts.
    Last (a profiler session slows later host launches), each family's
    decode step on the host clock and under the profiler: launches and
    device milliseconds a step. Counters are reset just before each path
    and read just after it."""
    from repro_torch.launch.mesh import TPMesh
    from repro_torch.qtensor import is_qtensor
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.loadgen import poisson_requests
    from repro_torch.serve.quantized import qw_path
    from repro_torch.utils.pytree import named_leaves

    card = torch.device("cuda", 0)
    res = {"paths": {}, "launches": {}, "seconds": {}}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        res["seconds"][name] = now - clock[0]
        clock[0] = now

    kept = {}
    for arch, n_requests, layers in RECURRENT_PATHS:
        gc.collect()
        torch.cuda.empty_cache()
        mp, keep = main_path(arch, n_requests, False, layers,
                             RECURRENT_PROMPTS)
        if n_requests <= keep["ecfg"].max_slots:
            raise AssertionError(f"3j: {n_requests} {arch} requests on "
                                 f"{keep['ecfg'].max_slots} slots reuse no slot")
        mp["state_bytes_per_slot"] = ssm_state_bytes(keep["cfg"])
        res["paths"][arch] = mp
        res["launches"][arch] = mp["launches"]
        keep.pop("report")
        kept[arch] = keep
        lap(f"{arch} main path")

    k = kept["zamba2_7b"]
    # the contracts below serve 8 short requests, all arrived at once, on
    # the engine's 4 slots and the step clock: the last 4 are admitted
    # into used slots
    ecfg = dataclasses.replace(k["ecfg"], clock="steps")
    n_reqs = RECURRENT_CONTRACT_REQUESTS
    if n_reqs <= ecfg.max_slots:
        raise AssertionError(f"3j: {n_reqs} requests on {ecfg.max_slots} "
                             "slots reuse no slot")

    def reqs():
        rs = poisson_requests(k["cfg"], n_reqs, rate=1.0, prompt_len=(8, 16),
                              gen_len=8, seed=3)
        for r in rs:
            r.arrival_time = 0.0
        return rs

    def serve(tag, ecfg, **kw):
        engine = Engine(k["qparams"], k["cfg"], ecfg, **kw)
        fin, m = engine.run(reqs())
        torch.cuda.synchronize()
        lap(tag)
        return engine, [r.output_tokens.tolist() for r in fin], m

    # 16-bit pages hold the dense cache's values: the same streams
    _, paged16, _ = serve("zamba2_7b paged 16-bit", ecfg)
    _, dense, _ = serve("zamba2_7b dense cache",
                        dataclasses.replace(ecfg, kv_cache="dense"))
    if paged16 != dense:
        raise AssertionError(f"zamba2_7b: 16-bit pages != dense cache: "
                             f"{paged16} vs {dense}")
    res["paged_equals_dense"] = {"requests": len(dense),
                                 "tokens": sum(map(len, dense))}

    # tp=2 on one card == the tp=1 engine, at the FIT KV widths
    kw = {"kv_bits": k["kv_bits"], "kv_ranges": k["ranges"]}
    _, tp1, _ = serve("zamba2_7b tp=1", ecfg, **kw)
    reset_counts()
    tp2, got, m = serve("zamba2_7b tp=2", dataclasses.replace(
        ecfg, mesh=TPMesh([card] * 2)), **kw)
    launches = res["launches"]["zamba2_7b tp=2"] = read_counts()
    if got != tp1:
        raise AssertionError(f"zamba2_7b tp=2 streams differ from tp=1's: "
                             f"{got} vs {tp1}")
    plan = tp2._shard_plan
    # packed row blocks, each counted once an application: the shared
    # block's run once a group
    cfg = k["cfg"]
    qrow = sum((cfg.num_layers // cfg.attn_period if name.startswith("shared/")
                else 1)
               for name, leaf in named_leaves(k["qparams"])
               if plan.get(qw_path(name)) == "row" and is_qtensor(leaf))
    fwd = m.prefill_tokens + m.decode_steps
    if (not qrow or tp2._kv_shards != 2
            or launches["qmm_groups"] != qrow * 2 * fwd
            or launches["qmm_groups_fold"] != qrow * fwd):
        raise AssertionError(
            f"zamba2_7b tp=2: {launches['qmm_groups']} qmm_groups / "
            f"{launches['qmm_groups_fold']} fold launches for {qrow} packed "
            f"row-block applications x 2 shards x {fwd} forward calls; kv "
            f"shards {tp2._kv_shards}")
    for name in PATH_KERNELS["hybrid_tp"]:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 "zamba2_7b tp=2 path")
    s = m.summary()
    res["tp2"] = {"blocks": {mode: sum(v == mode for v in plan.values())
                             for mode in ("col", "row")},
                  "packed_row_applications": qrow, "forward_calls": fwd,
                  "kv_shards": tp2._kv_shards,
                  "decode_tokens_per_s": s["decode_tokens_per_s"],
                  "decode_ms_per_step": 1e3 * m.decode_s / max(m.decode_steps, 1),
                  "ttft_p50": s["ttft_p50"]}
    del tp2

    # where a recurrent decode step goes (profiled last)
    for arch, keep in kept.items():
        engine = Engine(keep["qparams"], keep["cfg"], keep["ecfg"],
                        kv_bits=keep["kv_bits"], kv_ranges=keep["ranges"])
        res["paths"][arch]["step"] = step_profile(engine)
        del engine
        lap(f"{arch} step profile")
    del kept
    return res


HESSIAN_LAYERS = 4      # depth of phase 3h's model (full width)
HESSIAN_PROBES = 8


def hessian_path(arch: str = "internlm2_1_8b", batch: int = 4,
                 seq: int = 128) -> dict:
    """Phase 3h, FIT against the Hessian baseline on the card: ``arch`` at
    full width cut to HESSIAN_LAYERS layers, one batch of ``batch`` x
    ``seq``; the FIT report's EF weight traces (one backward a sample) and
    ``hutchinson_block_traces`` (HESSIAN_PROBES Rademacher probes from a
    seeded generator, fp32, reverse-over-reverse HVPs), each timed; the
    Spearman rank correlation of the per-block traces (a number, not a
    gate: the weights are random). Every trace must be finite, and two
    Hutchinson runs of one seed equal. Counters reset just before and
    read just after."""
    from repro_torch.configs import get_config
    from repro_torch.core import (ef_trace_weights, hutchinson_block_traces,
                                  spearman)
    from repro_torch.core.report import to_device_batch
    from repro_torch.data.synthetic import LMStreamConfig, lm_batches
    from repro_torch.models import init_params, loss_fn

    cfg = dataclasses.replace(get_config(arch), num_layers=HESSIAN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    params = init_params(cfg, seed=0)
    data = to_device_batch(next(lm_batches(LMStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0))),
        torch.device("cuda"))

    def loss(p, z):
        return loss_fn(p, z, cfg)

    t0 = time.perf_counter()
    ef = ef_trace_weights(loss, params, data)
    torch.cuda.synchronize()
    ef_s = time.perf_counter() - t0
    runs = []
    for _ in range(2):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hut, samples = hutchinson_block_traces(loss, params, data, gen,
                                               iters=HESSIAN_PROBES)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, hut,
                     {k: v.tolist() for k, v in samples.items()}))
    launches = read_counts()
    (hut_s, hut, samples), (hut_s2, hut2, samples2) = runs
    names = list(ef)
    if list(hut) != names:
        raise AssertionError("3h: EF and Hessian traces name other blocks")
    values = list(ef.values()) + [x for v in samples.values() for x in v]
    if not all(math.isfinite(x) for x in values):
        raise AssertionError("3h: a non-finite EF or Hessian trace")
    if hut2 != hut or samples2 != samples:
        raise AssertionError("3h: two Hutchinson runs of one seed differ")
    for name in PATH_KERNELS["hessian"]:
        if launches[name] <= 0:
            raise AssertionError(f"3h: kernel {name} was not launched")
    rho = spearman([ef[k] for k in names], [hut[k] for k in names])
    top = sorted(names, key=lambda k: ef[k], reverse=True)[:5]
    return {"arch": arch, "layers": cfg.num_layers, "batch": batch, "seq": seq,
            "probes": HESSIAN_PROBES, "blocks": len(names), "ef_s": ef_s,
            "hutchinson_s": hut_s, "hutchinson_s_again": hut_s2,
            "spearman": rho, "deterministic": True,
            "top_ef_blocks": {k: {"ef": ef[k], "hessian": hut[k]} for k in top},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}


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
