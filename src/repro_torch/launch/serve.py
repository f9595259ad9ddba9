"""Serving CLI (port of ``repro.launch.serve``): a thin driver over the
``repro_torch.serve`` continuous-batching engine, on the GPU.

Two traffic shapes:

  * closed-loop (default) — ``--batch`` identical requests at t=0;
    returns a dense ``generated`` matrix.
  * open-loop — ``--requests N --rate R`` Poisson arrivals through the
    load generator, exercising admission/eviction/backfill under load.

Quantization: ``--weight-bits B`` fake-quantizes in fp storage (PTQ
numerics check); adding ``--int8`` materializes int8-backed storage with
per-channel scales; adding ``--packed`` instead materializes packed
QTensor storage (sub-byte widths shrink weight memory: 0.75 B/elem at
W6, 0.5 at W4/W3). ``--int8-compute`` routes those matmuls through the
integer kernels: ``int8_matmul`` for int8-backed blocks, ``qmm`` (and
``grouped_qmm`` for MoE expert stacks) for packed ones.

KV cache: ``--paged`` switches the dense per-slot cache for the paged
pool (``repro_torch.kvcache``) with ``--page-size`` token pages,
``--kv-bits`` storage (8 = int8, 4 = packed int4), an optional
``--kv-pages`` pool budget, and hash-based prefix sharing with
copy-on-write (``--shared-prefix N`` gives the generated prompts a
common prefix; ``--no-prefix-sharing`` turns sharing off).

MoE archs (olmoe_1b_7b, deepseek_moe_16b): packed expert stacks serve
through the grouped ragged kernel by default; ``--moe-dispatch dense``
selects the per-expert loop (bit-identical outputs).

Tensor parallelism: ``--tp N`` shards the packed or int8-backed weight
blocks column-, row- or expert-wise and (paged) the KV page pools by kv
head across ``make_tp_mesh(N)``, the cards cuda:0..N-1, driven by this
one process; the tokens equal ``--tp 1``'s. It implies
``--int8-compute`` for quantized weights. ``serve(tp=N, device="cpu")``
puts the N shards on the CPU.

Sampling: ``--temperature`` (0 = greedy), ``--top-k``, ``--top-p`` with
per-request seeds from ``--seed``; a request samples the same tokens
alone or batched, at any ``--tp``.

Self-speculative decoding: ``--spec-k K`` drafts K tokens a dispatch
from the serving tree (the emitted tokens are the plain engine's, bit
for bit); ``--spec-bits B`` narrows the packed tree to B bits for the
draft (needs ``--packed``), ``--spec-bits fit:AVG`` to the widths
``core.fit.allocate_draft_bits`` spends an AVG-bit budget on from a
sensitivity report of the fp weights; ``--spec-kv-bits`` is the draft
lane's KV width (8 or 16 dense, any page width paged). The JSON dump
gains a ``"spec"`` entry (accept rate, dispatches, the FIT proxies).

Not ported yet, and refused with ``NotImplementedError`` when given a
value other than the default: ``--trace``, ``--events``,
``--metrics-*``, ``--drain-every``, ``--drift-*`` (ROADMAP A6).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2_1_8b \\
      --smoke --int8 --int8-compute --paged --kv-bits 8 --requests 4 \\
      --rate 0.05 --shared-prefix 24

Logs go to standard error; standard output holds the JSON dump only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from typing import Dict, Optional

import numpy as np

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.mesh import make_tp_mesh
from repro_torch.models.transformer import init_params
from repro_torch.quant.policy import QuantPolicy
from repro_torch.quant.quantizer import QuantSpec, fake_quant_ref
from repro_torch.serve import (
    Engine, EngineConfig, SamplingParams, SpecConfig, poisson_requests,
    quantize_params, quantize_params_int8, sharded_storage_bytes,
    trace_requests, weight_storage_bytes)
from repro_torch.utils.pytree import map_with_names

log = logging.getLogger("repro_torch.serve")


def quantize_weights(params, weight_bits: Optional[int],
                     policy: Optional[QuantPolicy] = None):
    """PTQ: fake-quantize matmul weights to ``weight_bits`` (fp storage).

    Pinning comes from ``QuantPolicy`` — the rule set MPQ search uses, so
    serving and search never disagree about which blocks stay
    high-precision."""
    if weight_bits is None or weight_bits >= 16:
        return params
    policy = policy or QuantPolicy()

    def one(name, leaf):
        if not policy.quantizable(name, leaf.ndim):
            return leaf
        return fake_quant_ref(leaf, QuantSpec(bits=weight_bits))

    return map_with_names(one, params)


def _refuse_unported(**flags) -> None:
    """Raise on a flag of a feature the port does not have yet (its
    ROADMAP item in the message) when it is away from its default."""
    unported = {
        "trace_path": (None, "observability (ROADMAP A6)"),
        "events_path": (None, "observability (ROADMAP A6)"),
        "metrics_file": (None, "observability (ROADMAP A6)"),
        "metrics_port": (None, "observability (ROADMAP A6)"),
        "drain_every": (8, "observability (ROADMAP A6)"),
        "drift_every": (0, "the FIT drift monitor (ROADMAP A6)"),
        "drift_stale": (1.0, "the FIT drift monitor (ROADMAP A6)"),
        "drift_threshold": (1.5, "the FIT drift monitor (ROADMAP A6)"),
    }
    for name, value in flags.items():
        default, what = unported[name]
        if value != default:
            raise NotImplementedError(
                f"{name}={value!r}: {what} is not ported to repro_torch yet")


def serve(arch: str, smoke: bool, batch: int, prompt_len: int, gen_len: int,
          weight_bits: Optional[int], seed: int = 0, int8: bool = False,
          packed: bool = False,
          int8_compute: bool = False, n_requests: Optional[int] = None,
          rate: float = 1.0, sampling: Optional[SamplingParams] = None,
          prefill_chunk: int = 32, decode_burst: int = 16,
          clock: str = "steps", paged: bool = False, page_size: int = 16,
          kv_bits: Optional[int] = None, kv_pages: Optional[int] = None,
          prefix_sharing: bool = True, shared_prefix: int = 0,
          tp: int = 1, group_size: Optional[int] = None,
          moe_dispatch: str = "grouped",
          trace_path: Optional[str] = None,
          events_path: Optional[str] = None,
          metrics_file: Optional[str] = None,
          metrics_port: Optional[int] = None, drain_every: int = 8,
          drift_every: int = 0, drift_stale: float = 1.0,
          drift_threshold: float = 1.5, spec_k: int = 0,
          spec_bits: Optional[str] = None,
          spec_kv_bits: Optional[int] = None,
          device: DeviceLike = None) -> Dict:
    """Build the model and engine on ``device`` (default: the GPU) and run
    the load. Returns the timings and ``metrics``, the finished
    ``requests``, the realized ``weight_bytes``, the ``engine`` (for
    further runs on the same weights) and, closed-loop, the
    ``generated`` (B, G) matrix; ``tp`` and ``shard_weight_bytes``, the
    weight bytes one shard holds; with ``spec_k`` > 1, ``spec`` (the
    reference's dict: accept rate, dispatches and, for ``fit:AVG``, the
    plan's FIT proxies)."""
    sampling = sampling or SamplingParams()
    _refuse_unported(
        trace_path=trace_path, events_path=events_path,
        metrics_file=metrics_file, metrics_port=metrics_port,
        drain_every=drain_every, drift_every=drift_every,
        drift_stale=drift_stale, drift_threshold=drift_threshold)
    spec_fit = spec_bits is not None and str(spec_bits).startswith("fit:")
    dev = resolve_device(device)
    mesh = None
    if tp > 1:
        mesh = make_tp_mesh(tp, dev)
        if (int8 or packed) and not int8_compute:
            # sharded quantized matmuls exist only on the integer kernel
            # route (the exact cross-shard combine): switch it on
            log.info("--tp %d with quantized weights: enabling "
                     "--int8-compute (required for sharded execution)", tp)
            int8_compute = True
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if int8 or packed or paged:
        # per-layer scales / page pools / payload shapes are path-keyed
        cfg = dataclasses.replace(cfg, scan_layers=False)
    params = init_params(cfg, seed=seed, device=dev)
    # the fp weights before PTQ: what the FIT draft report measures
    fp_params = params if spec_fit else None

    scales = None
    policy = QuantPolicy()
    if (int8 or packed) and weight_bits is None:
        weight_bits = 8          # --int8/--packed alone means W8 storage
    if weight_bits is not None and weight_bits < 16:
        if packed:
            params, _ = quantize_params(params, weight_bits, policy,
                                        group_size=group_size, device=dev)
            log.info("packed QTensor weights: %.0f bytes realized",
                     weight_storage_bytes(params))
        elif int8:
            params, scales = quantize_params_int8(params, weight_bits, policy,
                                                  device=dev)
        else:
            params = quantize_weights(params, weight_bits, policy)

    spec, draft_plan = None, None
    if spec_k and spec_k > 1:
        draft_bits = None
        if spec_bits is not None:
            if not packed:
                raise ValueError(
                    "--spec-bits narrows the packed QTensor tree for the "
                    "draft pass; it requires --packed")
            if spec_fit:
                draft_plan = _fit_draft_plan(cfg, fp_params, policy, seed,
                                             float(str(spec_bits).split(":", 1)[1]),
                                             dev)
                draft_bits = draft_plan.bits
                log.info("FIT draft plan: %.2f avg bits, KL proxy %.4g, "
                         "accept proxy %.2f", draft_plan.avg_bits,
                         draft_plan.kl_proxy, draft_plan.accept_proxy)
            else:
                draft_bits = int(spec_bits)
        spec = SpecConfig(k=spec_k, draft_bits=draft_bits,
                          draft_kv_bits=spec_kv_bits if spec_kv_bits
                          is not None else 8)
    del fp_params

    if n_requests is None:
        reqs = trace_requests(cfg, [(0.0, prompt_len, gen_len)] * batch,
                              sampling=sampling, seed=seed,
                              prefix_len=shared_prefix)
    else:
        reqs = poisson_requests(
            cfg, n_requests, rate,
            prompt_len=(max(1, prompt_len // 2), prompt_len),
            gen_len=(max(1, gen_len // 2), gen_len),
            sampling=sampling, seed=seed, prefix_len=shared_prefix)

    max_len = prompt_len + gen_len
    if paged:
        max_len = -(-max_len // page_size) * page_size    # page multiple
    ecfg = EngineConfig(
        max_slots=batch, max_len=max_len, max_new_tokens=gen_len,
        prefill_chunk=min(prefill_chunk, max(prompt_len, 1)),
        decode_burst=decode_burst, clock=clock, int8_compute=int8_compute,
        kv_cache="paged" if paged else "dense", page_size=page_size,
        kv_pages=kv_pages, prefix_sharing=prefix_sharing,
        moe_dispatch=moe_dispatch, mesh=mesh, spec=spec)
    engine = Engine(params, cfg, ecfg, scales=scales, kv_bits=kv_bits,
                    device=None if mesh else dev)
    finished, metrics = engine.run(reqs)
    summ = metrics.summary()

    out = {
        "prefill_s": metrics.prefill_s,
        "decode_s": metrics.decode_s,
        "tokens_per_s": summ["decode_tokens_per_s"] or 0.0,
        "metrics": summ,
        "requests": finished,
        "weight_bytes": weight_storage_bytes(params),
        "tp": tp,
        "shard_weight_bytes": sharded_storage_bytes(params, engine._shard_plan,
                                                    tp),
        "engine": engine,
    }
    if n_requests is None:
        # closed-loop: uniform lengths -> dense (B, G) matrix
        out["generated"] = np.stack([r.output_tokens for r in finished])
    if spec is not None:
        st = engine.spec_stats
        rate = st["accepted"] / max(st["proposed"], 1)
        out["spec"] = {"k": spec.k, "draft_bits": str(spec.draft_bits),
                       "draft_kv_bits": spec.draft_kv_bits,
                       "dispatches": st["dispatches"],
                       "proposed": st["proposed"],
                       "accepted": st["accepted"], "accept_rate": rate}
        if draft_plan is not None:
            out["spec"]["fit_avg_bits"] = draft_plan.avg_bits
            out["spec"]["fit_kl_proxy"] = draft_plan.kl_proxy
            out["spec"]["fit_accept_proxy"] = draft_plan.accept_proxy
        log.info("spec decode: k=%d, %d dispatches, accept rate %.0f%% "
                 "(%d/%d drafts)", spec.k, st["dispatches"], 100 * rate,
                 st["accepted"], st["proposed"])
    log.info("%s slots=%d bits=%s%s | prefill %.2fs, decode %.2fs "
             "(%.1f tok/s, occupancy %.0f%%)", cfg.name, batch, weight_bits,
             " int8" if int8 else "", metrics.prefill_s, metrics.decode_s,
             out["tokens_per_s"], 100 * (summ["slot_occupancy"] or 0))
    return out


def _fit_draft_plan(cfg, fp_params, policy: QuantPolicy, seed: int,
                    avg_bits: float, dev):
    """``--spec-bits fit:AVG``: a sensitivity report of the fp weights on
    two synthetic calibration batches, then ``allocate_draft_bits`` at
    an AVG-bit average."""
    from repro_torch.core import allocate_draft_bits, build_report
    from repro_torch.data.synthetic import LMStreamConfig, lm_batches
    from repro_torch.models.transformer import loss_fn

    stream = lm_batches(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                       global_batch=4, seed=seed))
    report = build_report(lambda p, b: loss_fn(p, b, cfg), None, None, None,
                          fp_params, [next(stream) for _ in range(2)],
                          microbatch=4, tolerance=None, max_batches=2,
                          device=dev)
    return allocate_draft_bits(report, policy, avg_bits=avg_bits)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8,
                    help="slot count (batch capacity)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--weight-bits", type=int, default=None)
    ap.add_argument("--int8", action="store_true",
                    help="int8-backed storage + DequantContext")
    ap.add_argument("--packed", action="store_true",
                    help="packed QTensor storage (sub-byte widths shrink "
                         "weight memory; repro_torch.qtensor)")
    ap.add_argument("--int8-compute", action="store_true",
                    help="route quantized blocks through the integer kernels")
    ap.add_argument("--requests", type=int, default=None,
                    help="open-loop: number of Poisson requests")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="open-loop arrival rate (requests per clock unit)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (repro_torch.kvcache): page pool + "
                         "prefix sharing instead of the dense per-slot cache")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size in tokens (paged mode)")
    ap.add_argument("--kv-bits", type=int, default=None,
                    help="uniform KV storage width: 16 (fp), 8 (int8), "
                         "4 (packed int4)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="page-pool size (default: full slot capacity)")
    ap.add_argument("--no-prefix-sharing", action="store_true")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give all generated prompts a common prefix of "
                         "this many tokens (exercises prefix sharing)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: shard quantized weight "
                         "blocks (and kv-head-divisible paged pools) "
                         "across cuda:0..N-1; outputs equal --tp 1's. "
                         "Implies --int8-compute with --int8/--packed")
    ap.add_argument("--group-size", type=int, default=None,
                    help="scale-group size along the reduction axis for "
                         "--packed")
    ap.add_argument("--moe-dispatch",
                    choices=("grouped", "dense", "einsum"),
                    default="grouped",
                    help="MoE expert dispatch for quantized stacks: one "
                         "grouped ragged kernel per projection (default), "
                         "the dense per-expert qmm loop (bit-identical "
                         "oracle), or the fp-dequant einsum fallback")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft tokens proposed per "
                         "dispatch (> 1 enables; the emitted tokens equal "
                         "non-speculative serving)")
    ap.add_argument("--spec-bits", default=None,
                    help="draft widths: an int narrows every packed block "
                         "to it; fit:AVG lets allocate_draft_bits spend an "
                         "AVG-bit budget from a FIT report (needs --packed)")
    ap.add_argument("--spec-kv-bits", type=int, default=None,
                    help="the draft lane's KV width (default 8; dense "
                         "serving takes 8 or 16)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clock", choices=("steps", "wall"), default="steps")
    ap.add_argument("--json", default=None, help="write metrics JSON here")
    # ---- observability (not ported yet) ----
    ap.add_argument("--trace", default=None, metavar="PATH")
    ap.add_argument("--events", default=None, metavar="PATH")
    ap.add_argument("--metrics-file", default=None, metavar="PATH")
    ap.add_argument("--metrics-port", type=int, default=None)
    ap.add_argument("--drain-every", type=int, default=8)
    ap.add_argument("--drift-every", type=int, default=0)
    ap.add_argument("--drift-stale", type=float, default=1.0)
    ap.add_argument("--drift-threshold", type=float, default=1.5)
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname).1s %(name)s] "
                               "%(message)s", datefmt="%H:%M:%S")

    out = serve(args.arch, args.smoke, args.batch, args.prompt_len,
                args.gen_len, args.weight_bits, seed=args.seed,
                int8=args.int8, packed=args.packed,
                int8_compute=args.int8_compute,
                n_requests=args.requests, rate=args.rate,
                sampling=SamplingParams(temperature=args.temperature,
                                        top_k=args.top_k, top_p=args.top_p,
                                        seed=args.seed),
                clock=args.clock, paged=args.paged, page_size=args.page_size,
                kv_bits=args.kv_bits, kv_pages=args.kv_pages,
                prefix_sharing=not args.no_prefix_sharing,
                shared_prefix=args.shared_prefix, tp=args.tp,
                group_size=args.group_size,
                moe_dispatch=args.moe_dispatch, trace_path=args.trace,
                events_path=args.events, metrics_file=args.metrics_file,
                metrics_port=args.metrics_port,
                drain_every=args.drain_every,
                drift_every=args.drift_every, drift_stale=args.drift_stale,
                drift_threshold=args.drift_threshold, spec_k=args.spec_k,
                spec_bits=args.spec_bits, spec_kv_bits=args.spec_kv_bits)
    dump = {"metrics": out["metrics"], "tp": out["tp"],
            "shard_weight_bytes": out["shard_weight_bytes"]}
    if "spec" in out:
        dump["spec"] = out["spec"]
    print(json.dumps(dump, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dump, f, indent=2)


if __name__ == "__main__":
    main()
