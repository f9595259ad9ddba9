"""End-to-end FIT-policy -> engine demo on the PyTorch/CUDA port: compute
a sensitivity report, allocate per-block bits with the greedy knapsack,
materialize the config as REAL packed QTensor storage, and serve Poisson
traffic through the continuous-batching engine. Runs on the GPU unless
given ``--device cpu``.

The engine serves the packed tree on the integer route
(``int8_compute=True``: W{8,6,4,3}A8 through the ``qmm`` kernel), as the
serving main path does. The FIT-predicted weight budget (bits/param from
the BitConfig) is
printed next to the realized packed bytes (``repro_torch.qtensor``
payloads — nibbles at W4/W3, 3-bytes-per-4 at W6) and next to what the
same config would cost int8-backed or fp16.

Reports per-request greedy-token agreement vs the fp engine (requests
differ in prompt/generation length, so each is compared with its own fp
twin), then a seeded-sampling run to show sampled decoding is
deterministic per request seed, then the paged KV cache: FIT's
activation sensitivities allocate per-layer KV bit widths under an HBM
budget and the engine serves prefix-shared traffic from QTensor pages.

    PYTHONPATH=src python examples/serve_quantized_torch.py --bits mixed
    PYTHONPATH=src python examples/serve_quantized_torch.py --bits 4 --device cpu
"""
import argparse

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs import smoke_config
from repro_torch.core import build_report
from repro_torch.data.synthetic import LMStreamConfig, lm_batches
from repro_torch.kernels import ef_sqnorm, paged_attention, qmm
from repro_torch.kvcache import dense_kv_bytes
from repro_torch.models import init_params, loss_fn
from repro_torch.qtensor import is_qtensor, storage_summary
from repro_torch.quant.policy import BitConfig, QuantPolicy
from repro_torch.serve import (
    Engine, EngineConfig, SamplingParams, allocate_kv_bits,
    bit_config_from_report, kv_bit_config, kv_report_fns, poisson_requests,
    quantize_params)
from repro_torch.utils.pytree import named_leaves

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--bits", default="mixed",
                help="'mixed' = FIT greedy W4/W8 split at a 6.0-bit "
                     "average budget; or a uniform width (8/6/4/3 — "
                     "policy-pinned blocks stay at >= 8)")
ap.add_argument("--requests", type=int, default=8)
ap.add_argument("--device", default=None, help="default: the GPU")
args = ap.parse_args()
dev = resolve_device(args.device)

ARCH = "internlm2_1_8b"
N_REQ, RATE = args.requests, 0.05
SLOTS, MAX_LEN, MAX_NEW = 4, 96, 24

cfg = smoke_config(ARCH)
params = init_params(cfg, seed=0, device=dev)
stream = lm_batches(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=4, seed=0))

print("== FIT sensitivity report (per-sample gradient traces) ==")
# tap the per-layer attn/k + attn/v sites too: the KV cache is a
# persistent activation, so its sensitivities ride the same report
tap_loss, tap_shapes, act_fn = kv_report_fns(cfg)
report = build_report(lambda p, b: loss_fn(p, b, cfg), tap_loss,
                      lambda b: tap_shapes(params, b), act_fn,
                      params, [next(stream) for _ in range(2)],
                      microbatch=4, tolerance=None, max_batches=2, device=dev)

if args.bits == "mixed":
    # a FIT-driven W4/W8 split: with only {4, 8} allowed, the greedy
    # knapsack at 6.0 bits/param keeps sensitive blocks at W8 and packs
    # the rest into nibbles
    policy = QuantPolicy(allowed_bits=(8, 4))
    bit_cfg = bit_config_from_report(report, policy, avg_bits=6.0)
else:
    # uniform W-N everywhere the policy allows (pinned blocks stay >= 8)
    policy = QuantPolicy(allowed_bits=(8, 6, 4, 3))
    b = int(args.bits)
    bit_cfg = policy.sanitize(
        BitConfig({k: b for k in report.weight_traces}, {}))
hist = {}
for b in bit_cfg.weight_bits.values():
    hist[b] = hist.get(b, 0) + 1
print(f"allocation ({args.bits}): {dict(sorted(hist.items()))} "
      f"(FIT_W = {report.fit_weights(bit_cfg.weight_bits):.5f})")

print("\n== materialize packed QTensor storage + serve Poisson traffic ==")
qparams, _ = quantize_params(params, bit_cfg, policy, device=dev)

# FIT-predicted budget vs realized packed bytes, quantized blocks only
ws = storage_summary(qparams)
print(f"quantized weight storage: FIT-predicted "
      f"{ws['predicted_bytes'] / 1024:.1f} KiB "
      f"-> packed {ws['packed_bytes'] / 1024:.1f} KiB "
      f"(int8-backed {ws['int8_backed_bytes'] / 1024:.1f} KiB, "
      f"fp16 {ws['fp16_bytes'] / 1024:.1f} KiB; "
      f"packed/int8 = {ws['packed_bytes'] / ws['int8_backed_bytes']:.2f}x)")
# the payloads alone (scales excluded): W8 is a byte, W6 three bytes per
# four values, W4 a nibble, so they equal the predicted bits; W3 is
# stored in nibbles, a quarter over its prediction
payload = sum(leaf.nbytes for _, leaf in named_leaves(qparams)
              if is_qtensor(leaf))
print(f"packed payload {payload} B == FIT-predicted "
      f"{ws['predicted_bytes']:.0f} B: {payload == ws['predicted_bytes']}")

# the integer route: every packed block a W{8,6,4,3}A8 matmul (the
# activation row-quantized to int8), as the serving main path runs it
ecfg = EngineConfig(max_slots=SLOTS, max_len=MAX_LEN, max_new_tokens=MAX_NEW,
                    prefill_chunk=16, decode_burst=8, int8_compute=True)


def run(p, sampling):
    reqs = poisson_requests(cfg, N_REQ, RATE, prompt_len=(8, 32),
                            gen_len=(8, MAX_NEW), sampling=sampling, seed=1)
    eng = Engine(p, cfg, ecfg, device=dev)     # QTensor storage auto-detected
    return eng.run(reqs)


greedy = SamplingParams(temperature=0.0)
fp_fin, fp_m = run(params, greedy)
q_fin, q_m = run(qparams, greedy)

# per-request agreement: batches are ragged, so compare each request's
# token stream against its own fp twin (same id -> same prompt/budget)
print("per-request greedy agreement (FIT-packed vs fp):")
for f, q in zip(fp_fin, q_fin):
    n = min(f.num_generated, q.num_generated)
    agree = float(np.mean(np.asarray(f.output_tokens[:n])
                          == np.asarray(q.output_tokens[:n])))
    print(f"  req {f.id}: prompt={f.prompt_len:3d} gen={n:3d} "
          f"agree={agree:6.1%} ttft={q.ttft:.0f} ticks")

for name, m in (("fp", fp_m), ("packed", q_m)):
    s = m.summary()
    print(f"{name}: {s['decode_tokens_per_s']:.1f} tok/s decode, "
          f"occupancy {s['slot_occupancy']:.0%}, "
          f"ttft p95 {s['ttft_p95']:.0f} ticks")

print("\n== seeded sampling determinism ==")
sp = SamplingParams(temperature=0.9, top_k=32, top_p=0.95, seed=123)
s1, _ = run(qparams, sp)
s2, _ = run(qparams, sp)
same = all(np.array_equal(a.output_tokens, b.output_tokens)
           for a, b in zip(s1, s2))
print("two runs, same request seeds -> identical samples:", same)

print("\n== FIT-allocated paged KV cache ==")
# budget: 6 bits/element on average (2.7x under fp16) -> the greedy
# allocator keeps the most KV-sensitive layers at int8 and packs the
# rest into int4 nibbles
kv_elems = dense_kv_bytes(cfg, SLOTS, MAX_LEN, bits=8)   # 1 B/elem = count
budget = 6.0 / 8.0 * kv_elems
kv_bits = allocate_kv_bits(report, cfg, QuantPolicy(), budget,
                           tokens=SLOTS * MAX_LEN)
print(f"KV bits per layer @ {budget:.0f}B budget "
      f"(fp16 = {2 * kv_elems:.0f}B): {kv_bits}")
print("as a policy BitConfig (act sites):",
      dict(sorted(kv_bit_config(kv_bits, cfg).act_bits.items())))

pecfg = EngineConfig(max_slots=SLOTS, max_len=MAX_LEN, max_new_tokens=MAX_NEW,
                     prefill_chunk=16, decode_burst=8, kv_cache="paged",
                     page_size=16, int8_compute=True)
pengine = Engine(qparams, cfg, pecfg, kv_bits=kv_bits,
                 kv_ranges=report.act_ranges, device=dev)
preqs = poisson_requests(cfg, N_REQ, RATE, prompt_len=(8, 32),
                         gen_len=(8, MAX_NEW), prefix_len=24, seed=1)
pfin, pm = pengine.run(preqs)
ps = pm.summary()
print(f"paged QTensor-page engine: {ps['n_finished']} finished, "
      f"{ps['decode_tokens_per_s']:.1f} tok/s, "
      f"KV peak {ps['kv_peak_bytes']:.0f}B of {ps['kv_pool_bytes']:.0f}B "
      f"pool ({ps['kv_peak_occupancy']:.0%}), "
      f"{ps['kv_shared_tokens']} prompt tokens prefix-shared, "
      f"{ps['kv_cow_copies']} copy-on-writes")
print(f"kernel launches on {dev}: ef_sqnorm {ef_sqnorm.launches}, "
      f"qmm {qmm.launches}, paged_attention {paged_attention.launches}")
print("(on the GPU the report's per-sample squared norms run the "
      "hand-written ef_sqnorm kernel, every packed W{8,6,4,3}A8 matmul the "
      "qmm kernel — sub-byte weights unpacked in registers, one launch a "
      "matmul — and decode attention, dense or paged, reads its cache "
      "through the paged_attention kernel; on the CPU each runs its plain "
      "PyTorch version, so the launch counts there are 0.)")
