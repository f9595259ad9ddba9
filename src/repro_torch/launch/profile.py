"""Performance profiling CLI (port of ``repro.launch.profile``), on the
GPU unless ``profile(device="cpu")``.

Runs one FIT-quantized serve on the packed QTensor + paged-KV stack
with the full profiling ObsConfig on (trace + device counters +
device-timed dispatch spans), then joins three views per kernel site:

  measured  — dispatch walls around each dispatch's one host read,
              with CUDA-event device time on the card and the
              compile-vs-execute split (kernel library loads);
  predicted — the analytic QTensor cost model's bytes-moved / op
              counts from the realized packed layouts;
  quality   — per-site FIT scores from a calibrated SensitivityReport.

and emits the site -> (FIT score, predicted bytes, measured ms share)
table, a Chrome trace carrying the device-timing track (validated), and
a schema-versioned JSON payload. It never opens ``torch.profiler``: a
profiler session slows every later host launch of its process.

  PYTHONPATH=src python -m repro_torch.launch.profile --arch internlm2_1_8b \\
      --smoke --weight-bits 4 --group-size 8 --kv-bits 8 --requests 6 \\
      --json profile.json --trace profile_trace.json
  # FIT mixed-precision allocation instead of a uniform width:
  PYTHONPATH=src python -m repro_torch.launch.profile --arch internlm2_1_8b \\
      --smoke --avg-bits 4.5 --kv-bits 8 --requests 6

Logs go to standard error; standard output holds the table.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from typing import Any, Dict, Optional

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import build_report
from repro_torch.data.synthetic import LMStreamConfig, lm_batches
from repro_torch.models.transformer import init_params, loss_fn
from repro_torch.obs import ObsConfig, validate_chrome_trace
from repro_torch.obs.perf import (
    attribute, format_table, roofline, site_costs_from_tree)
from repro_torch.quant.policy import QuantPolicy
from repro_torch.serve import (
    Engine, EngineConfig, bit_config_from_report, poisson_requests,
    quantize_params)

log = logging.getLogger("repro_torch.launch.profile")

PROFILE_SCHEMA = 1


def profile(arch: str = "internlm2_1_8b", smoke: bool = True,
            batch: int = 2, prompt_len: int = 24, gen_len: int = 12,
            n_requests: int = 6, rate: float = 0.05,
            weight_bits: int = 4, avg_bits: Optional[float] = None,
            group_size: Optional[int] = 8, kv_bits: int = 8,
            page_size: int = 8, time_every: int = 1, top: int = 12,
            seed: int = 0, trace_path: Optional[str] = None,
            json_path: Optional[str] = None,
            device: DeviceLike = None) -> Dict[str, Any]:
    """One profiled serve on ``device`` (default: the GPU); returns (and
    optionally writes) the joined per-site payload. See module
    docstring."""
    dev = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(cfg, scan_layers=False)
    params = init_params(cfg, seed=seed, device=dev)

    # calibrated sensitivity: FIT column + activation ranges for the
    # per-page KV dequant scales (same recipe as benchmarks/serve_bench)
    stream = lm_batches(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                       global_batch=4, seed=seed))
    report = build_report(lambda p, b: loss_fn(p, b, cfg), None, None, None,
                          params, [next(stream) for _ in range(2)],
                          microbatch=4, tolerance=None, max_batches=2,
                          device=dev)
    policy = QuantPolicy(allowed_bits=(8, 6, 4, 3))
    if avg_bits is not None:
        bits = bit_config_from_report(report, policy, avg_bits=avg_bits)
        qparams, _ = quantize_params(params, bits, policy, device=dev)
    else:
        qparams, _ = quantize_params(params, weight_bits,
                                     group_size=group_size, device=dev)
    del params

    obs = ObsConfig(trace=True, device_metrics=True, perf=True,
                    time_every=time_every, drain_every=4)
    max_len = prompt_len + gen_len
    max_len += (-max_len) % page_size
    ecfg = EngineConfig(max_slots=batch, max_len=max_len,
                        max_new_tokens=gen_len, prefill_chunk=8,
                        decode_burst=8, int8_compute=True,
                        kv_cache="paged", page_size=page_size, obs=obs)
    engine = Engine(qparams, cfg, ecfg, kv_bits=kv_bits,
                    kv_ranges=report.act_ranges, device=dev)
    reqs = poisson_requests(
        cfg, n_requests, rate,
        prompt_len=(max(4, prompt_len // 2), prompt_len),
        gen_len=(max(2, gen_len // 2), gen_len), seed=seed)
    finished, metrics = engine.run(reqs)
    summ = metrics.summary()

    # the analytic cost model at this run's decode shape: full batch,
    # mid-generation context (prompt + half the new tokens)
    costs = site_costs_from_tree(
        qparams, batch, context=prompt_len + gen_len // 2,
        kv_bits=kv_bits if kv_bits else 16, page_size=page_size, cfg=cfg)
    rows = attribute(costs, metrics.decode_s, report=report)
    rl = roofline(costs)

    print(f"\n{cfg.name}: {len(finished)} requests, "
          f"{summ.get('decode_tokens', 0)} decode tokens, "
          f"{summ.get('decode_tokens_per_s', 0.0):.1f} tok/s")
    print(format_table(rows, top=top))
    timing = engine.perf.summary()
    for kind, st in sorted(timing.items()):
        print(f"{kind:>14}: n={st['count']:<4} exec={st['exec_s']:.4f}s "
              f"compile={st['compile_s']:.4f}s "
              f"({st['compiled']} kernel-library loads) "
              f"device={st['device_s']:.4f}s sampled={st['sampled']}")

    payload = {
        "schema": PROFILE_SCHEMA,
        "arch": cfg.name,
        "weight_bits": None if avg_bits is not None else weight_bits,
        "avg_bits": avg_bits,
        "kv_bits": kv_bits,
        "group_size": group_size,
        "n_requests": len(finished),
        "sites": [r.as_dict() for r in rows],
        "timing": timing,
        "roofline_totals": rl["totals"],
        "metrics": summ,
    }
    if trace_path:
        engine.tracer.write(trace_path)
        problems = validate_chrome_trace(engine.tracer.chrome_trace())
        if problems:
            raise AssertionError(f"invalid chrome trace: {problems[:3]}")
        log.info("chrome trace (device track included) -> %s", trace_path)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(payload, f, indent=1)
        log.info("profile payload -> %s", json_path)
    return payload


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen-len", type=int, default=12)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--rate", type=float, default=0.05)
    ap.add_argument("--weight-bits", type=int, default=4)
    ap.add_argument("--avg-bits", type=float, default=None,
                    help="FIT mixed-precision target instead of uniform")
    ap.add_argument("--group-size", type=int, default=8)
    ap.add_argument("--kv-bits", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--time-every", type=int, default=1,
                    help="device-track trace cadence (1 = every dispatch)")
    ap.add_argument("--top", type=int, default=12,
                    help="table rows before the tail is folded")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="Chrome trace JSON with the device-timing track")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="schema-versioned profile payload")
    a = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname).1s %(name)s] "
                               "%(message)s", datefmt="%H:%M:%S")
    profile(arch=a.arch, smoke=a.smoke, batch=a.batch,
            prompt_len=a.prompt_len, gen_len=a.gen_len,
            n_requests=a.requests, rate=a.rate, weight_bits=a.weight_bits,
            avg_bits=a.avg_bits, group_size=a.group_size, kv_bits=a.kv_bits,
            page_size=a.page_size, time_every=a.time_every, top=a.top,
            seed=a.seed, trace_path=a.trace, json_path=a.json)


if __name__ == "__main__":
    main()
