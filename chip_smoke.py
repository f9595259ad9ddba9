"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --kernels-only  # build + kernel checks only

Phases, in order; any failure exits non-zero:
  1. print the card and its power limit; build the CUDA kernels from
     src/repro_torch/kernels/csrc with nvcc for sm_90a (one nvcc per
     source, all started together);
  2. hold every kernel against its plain PyTorch version on the card at
     the main paths' shapes, and time kernel, plain version and the one
     PyTorch library call computing the same function (CUDA events);
  3a. the packed paged decode of the internlm2_1_8b, olmoe_1b_7b and
     deepseek_moe_16b smoke configs on the card against the CPU plain path;
  3b. drive each main path at full width — internlm2_1_8b (dense) and
     olmoe_1b_7b (MoE, grouped_qmm) — seeded init -> FIT report -> W4/W8
     bit allocation -> packed QTensors -> FIT KV widths -> paged serving
     of Poisson requests (greedy), with every kernel launch counter reset
     just before each path and read just after its serving run;
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


def check_qmm(timer, gen, rows):
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
                y, dots = kmod.qmm(xq, qt, xs, return_dots=True)
                want_dots = ref.qmm_group_dots(xq, qt)
                want = ref.qmm(xq, qt, xs.reshape(-1, 1))
                torch.cuda.synchronize()
                if not torch.equal(dots, want_dots):
                    raise AssertionError(f"qmm {name} W{bits} M={m}: int32 "
                                         "group dots differ from the plain "
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
                rows.append(row)
                log(json.dumps(row))
            del qt, wd
        del w


GROUPED_SHAPES = [("w_up/w_gate", 2048, 1024), ("w_down", 1024, 2048)]
GROUPED_CAPS = (1, 5, 20)     # decode/prefill capacity; ragged; report batch
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
    for name, k, n in GROUPED_SHAPES:
        w = torch.randn((s, k, n), generator=gen, device="cuda") / k ** 0.5
        for bits in (8, 6, 4, 3):
            qt = quantize_experts(w, bits, group_size=128)
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
                groups = k // 128
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


def check_paged_attention(timer, gen, rows, b=4, kvh=8, g=2, dh=128, page=16,
                          max_len=256):
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as kmod, ref
    from repro_torch.qtensor import unpack

    np_ = max_len // page
    p = b * np_
    lengths = torch.tensor([1, 37, 130, 256], dtype=torch.int32, device="cuda")
    perm = torch.randperm(p, generator=gen, device="cuda").to(torch.int32)
    table = perm.reshape(b, np_).clone()
    for i, ln in enumerate(lengths.tolist()):
        used = -(-ln // page)
        table[i, used:] = p + i          # unmapped tail (ids >= P)
    q = torch.randn((b, kvh, g, dh), generator=gen, device="cuda").to(torch.bfloat16)
    for bits in (16, 8, 6, 4, 3):
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
        # the one library call: SDPA over the gathered, dequantized pages
        ids = table.clamp(0, p - 1).long()
        kg, vg = kp[ids], vp[ids]
        if bits < 16:
            kg = unpack(kg, bits).float() * ks[ids][:, :, None, :, None]
            vg = unpack(vg, bits).float() * vs[ids][:, :, None, :, None]
        kd = kg.reshape(b, max_len, kvh, dh).to(torch.bfloat16)
        vd = vg.reshape(b, max_len, kvh, dh).to(torch.bfloat16)
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
               "shape": f"B={b} KV={kvh} G={g} Dh={dh} page={page} W{bits}",
               "bits": bits, "max_abs_err": err,
               "ms": timer(lambda: kmod.paged_attention(q, kp, vp, table,
                                                        lengths, ks, vs, bits)),
               "plain_ms": timer(lambda: ref.paged_attention(
                   q.reshape(b, 1, kvh * g, dh), kp, vp, table,
                   lengths.long() - 1, ks, vs, bits)),
               "library_ms": timer(lambda: F.scaled_dot_product_attention(
                   qd, kd, vd, attn_mask=mask)),
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log(json.dumps(row))


# --------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phase 2)")
    args = ap.parse_args()

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
    ptx = sorted(_build.BUILD_DIR.glob("*/ptxas.log"))
    if ptx:
        log(ptx[-1].read_text()[-3000:])

    # ---- phase 2: kernels vs plain versions ----
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = Timer()
    rows: list = []
    t0 = time.perf_counter()
    check_ef_sqnorm(timer, gen, rows)
    check_paged_attention(timer, gen, rows)
    check_paged_attention(timer, gen, rows, kvh=16, g=1)      # olmoe's GQA
    check_qmm(timer, gen, rows)
    check_grouped_qmm(timer, gen, rows)
    log(f"phase 2: {len(rows)} kernel checks passed in "
        f"{time.perf_counter() - t0:.1f} s")
    result = {"card": card, "kind": kind, "kernel_checks": rows}

    if not args.kernels_only:
        result["small_reference_err"] = errs = {
            arch: check_small_reference(arch) for arch in SMOKE_ARCHS}
        log(f"phase 3a: smoke-config decode on the card agrees with the CPU "
            f"plain path (max err {errs})")
        result["main_paths"] = {}
        for arch, microbatch in MAIN_PATHS:
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            result["main_paths"][arch] = mp = main_path(arch, microbatch)
            log(f"phase 3b: {arch} main path in {time.perf_counter() - t0:.1f} s, "
                f"peak device memory {mp['peak_mem_gb']:.1f} GB")
            log(json.dumps({"main_path": mp}))

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    if args.kernels_only:
        return 0
    mps = result["main_paths"]
    log(json.dumps({"kernels": kernels_line(rows, mps)}))
    for arch, mp in mps.items():
        log(f"[{card}] {arch}: report {mp['report_s']:.2f} s; packed weights "
            f"{mp['packed_bytes'] / 1e9:.3f} GB vs FIT-predicted "
            f"{mp['predicted_bytes'] / 1e9:.3f} GB; decode "
            f"{mp['decode_tokens_per_s']:.1f} tok/s; TTFT p50 "
            f"{mp['ttft_p50']:.3f} s p95 {mp['ttft_p95']:.3f} s; peak "
            f"{mp['peak_mem_gb']:.1f} GB")
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
    ("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:90",
     "B=4 KV=8 G=2 Dh=128 page=16 W8"),
    ("grouped_qmm", "src/repro_torch/kernels/csrc/grouped_qmm.cu",
     "src/repro/kernels/grouped_qmm.py:125", "w_up/w_gate 2048x1024 W4 C=1"),
]
SMOKE_ARCHS = ("internlm2_1_8b", "olmoe_1b_7b", "deepseek_moe_16b")
# full-width main paths (arch, report microbatch), driven in this order
MAIN_PATHS = (("internlm2_1_8b", 4), ("olmoe_1b_7b", 2))
# the kernels each family's main path must launch
PATH_KERNELS = {"dense": ("ef_sqnorm", "qmm", "paged_attention"),
                "moe": ("ef_sqnorm", "qmm", "paged_attention", "grouped_qmm")}


def _kernel_modules():
    from repro_torch.kernels import ef_sqnorm, grouped_qmm, paged_attention, qmm
    return {"ef_sqnorm": ef_sqnorm, "qmm": qmm,
            "paged_attention": paged_attention, "grouped_qmm": grouped_qmm}


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
    """One full-width main path; returns its metrics. Every kernel counter
    is set to 0 at the start and read right after the serving run."""
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
    mods = _kernel_modules()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0

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
    res["launches"] = {name: mod.launches for name, mod in mods.items()}
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
    res["profile"] = profile_serving(engine, cfg)
    s = metrics.summary()
    res.update({k: s[k] for k in ("decode_tokens_per_s", "prefill_tokens_per_s",
                                  "ttft_p50", "ttft_p95", "e2e_p50",
                                  "token_latency_p50_ms", "decode_tokens",
                                  "kv_peak_bytes", "kv_pool_bytes")})
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


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
    only). Device busy share = summed kernel time (one stream, so kernels
    do not overlap) over the unprofiled wall time; the rest is the host
    (Python dispatch)."""
    from repro_torch.serve.loadgen import poisson_requests

    def reqs():
        rs = poisson_requests(cfg, 4, rate=1.0, prompt_len=8, gen_len=16,
                              seed=2)
        for r in rs:
            r.arrival_time = 0.0
        return rs

    engine.run(reqs())                            # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = engine.run(reqs())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        engine.run(reqs())
        torch.cuda.synchronize()

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return float(getattr(e, attr))
        return 0.0

    evs = [e for e in prof.key_averages() if dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in evs)
    top = sorted(evs, key=dev_us, reverse=True)[:n_top]
    s = m.summary()
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "prefill_s": m.prefill_s, "decode_s": m.decode_s,
            "decode_steps": m.decode_steps,
            "decode_ms_per_step": 1e3 * m.decode_s / max(m.decode_steps, 1),
            "prefill_ms_per_token": 1e3 * m.prefill_s / max(m.prefill_tokens, 1),
            "decode_tokens_per_s": s["decode_tokens_per_s"],
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": dev_us(e) / 1e3} for e in top]}


def kernels_line(rows, mps):
    """One entry per kernel; ``launches`` sums the main paths' runs."""
    out = []
    for name, source, replaces, shape in KERNELS:
        row = next(r for r in rows if r["kernel"] == name and r["shape"] == shape)
        launches = sum(mp["launches"][name] for mp in mps.values())
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    return out


if __name__ == "__main__":
    sys.exit(main())
