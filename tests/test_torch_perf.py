"""The port's performance observability (``repro_torch.obs.perf``) against
the reference's (``repro.obs.perf``) on the CPU:

  * the cost model's weight bytes == the port's realized packed storage
    (``storage_summary``) == the reference's cost, to the byte, at every
    width x group size; per-site costs of the dense and MoE smoke trees
    and the KV pool bytes == the reference's;
  * the H100 machine balance, and ``roofline`` held to its formula;
  * ``DispatchTimer``: the trace cadence, the compile split (the kernel
    loader's count stepped by hand), device time beside the wall;
  * trajectory files written by either package read by the other, with
    the reference's metric directions and regression cases;
  * a profiled engine's trace with its device track;
  * ``launch.profile.profile(device="cpu")``: the reference's payload
    keys, and its site rows (predicted bytes exactly) as the reference's
    cost model gives them for the same packed tree."""
import ast
import dataclasses
import inspect
import json
import os

import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.launch import profile as jprofile
from repro.obs import perf as jperf
from repro.obs.perf import history as jhist
from repro_torch import qtensor as tq
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.kernels import _build
from repro_torch.kvcache.paged import PagedKVConfig, init_paged_kv
from repro_torch.launch import profile as tprofile
from repro_torch.models.transformer import init_params
from repro_torch.obs import ObsConfig, Tracer, validate_chrome_trace
from repro_torch.obs import perf
from repro_torch.obs.perf import history
from repro_torch.obs.perf.timing import DeviceSpan
from repro_torch.obs.trace import DEVICE_TID
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.loadgen import trace_requests
from repro_torch.serve.quantized import quantize_params
from test_torch_tp import _to_jax
from _torch_threads import _one_thread  # noqa: F401

WIDTHS = [8, 6, 4, 3]
GROUPS = [8, 16, None]
COST_FIELDS = ("site", "kind", "bits", "bytes_weight", "bytes_act",
               "bytes_out", "int_ops", "fp_ops")


def _weights(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape)
                            .astype(np.float32))


@pytest.mark.parametrize("bits", WIDTHS)
@pytest.mark.parametrize("group_size", GROUPS)
def test_qmm_weight_bytes_equal_storage_and_reference(bits, group_size):
    k, n = 32, 24
    qt = tq.quantize(_weights((k, n)), bits, group_size=group_size)
    packed = tq.storage_summary([qt])["packed_bytes"]
    got = perf.qmm_weight_bytes(k, n, bits, group_size)
    assert got == packed == jperf.qmm_weight_bytes(k, n, bits, group_size)
    c = perf.qmm_cost("w", 4, k, n, bits, group_size)
    jc = jperf.qmm_cost("w", 4, k, n, bits, group_size)
    assert c.bytes_weight == packed
    assert [getattr(c, f) for f in COST_FIELDS] == \
        [getattr(jc, f) for f in COST_FIELDS]


@pytest.mark.parametrize("bits", WIDTHS)
@pytest.mark.parametrize("group_size", GROUPS)
def test_grouped_qmm_weight_bytes_equal_storage_and_reference(bits,
                                                              group_size):
    """The (E, K, N) stack's bytes == its packed storage == E x one
    expert's (one grouped dispatch streams what E per-expert ones do)."""
    e, k, n = 4, 32, 24
    stack = tq.quantize_experts(_weights((e, k, n)), bits,
                                group_size=group_size)
    packed = tq.storage_summary([stack])["packed_bytes"]
    got = perf.grouped_qmm_weight_bytes(e, k, n, bits, group_size)
    assert got == packed == jperf.grouped_qmm_weight_bytes(e, k, n, bits,
                                                           group_size)
    assert packed == e * tq.storage_summary(
        [tq.expert_slice(stack, 0)])["packed_bytes"]
    c = perf.grouped_qmm_cost("moe/w_up", e, 4, k, n, bits, group_size)
    jc = jperf.grouped_qmm_cost("moe/w_up", e, 4, k, n, bits, group_size)
    assert c.kind == "grouped_qmm" and c.bytes_weight == packed
    assert [getattr(c, f) for f in COST_FIELDS] == \
        [getattr(jc, f) for f in COST_FIELDS]


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "deepseek_moe_16b"])
def test_site_costs_from_tree_equal_reference(arch):
    """Every site of a packed smoke tree (and, for the dense tree, one
    paged-attention site a layer) costs what the reference's model gives
    the same bytes; the weight bytes cover the tree's storage exactly."""
    tcfg = dataclasses.replace(t_smoke(arch), scan_layers=False)
    jcfg = dataclasses.replace(j_smoke(arch), scan_layers=False)
    qp, _ = quantize_params(init_params(tcfg, seed=0, device="cpu"), 4,
                            group_size=8, device="cpu")
    kw = dict(context=48, kv_bits=8, page_size=8) if tcfg.family == "dense" \
        else {}
    got = perf.site_costs_from_tree(qp, 4, cfg=tcfg, **kw)
    want = jperf.site_costs_from_tree(_to_jax(qp), 4, cfg=jcfg, **kw)
    assert list(got) == list(want) and got
    for site, c in got.items():
        assert [getattr(c, f) for f in COST_FIELDS] == \
            [getattr(want[site], f) for f in COST_FIELDS], site
    kinds = {c.kind for c in got.values()}
    assert ("grouped_qmm" in kinds) == (tcfg.family == "moe")
    total = sum(c.bytes_weight for c in got.values()
                if c.kind in ("qmm", "grouped_qmm"))
    assert total == tq.storage_summary(qp)["packed_bytes"]


@pytest.mark.parametrize("bits", [16, 8, 6, 4, 3])
def test_kv_pool_bytes_equal_live_pages_and_reference(bits):
    cfg = dataclasses.replace(t_smoke("internlm2_1_8b"), scan_layers=False)
    pcfg = PagedKVConfig.build(cfg, 64, 2, page_size=8,
                               kv_bits=None if bits == 16 else bits)
    lp = init_paged_kv(cfg, pcfg, 2, device="cpu").layers["0"]
    live = lp.k.nbytes + lp.v.nbytes
    if bits < 16:
        live += lp.k_scale.nbytes + lp.v_scale.nbytes
    fp = lp.k.element_size() if bits == 16 else 2.0
    args = (pcfg.num_pages, pcfg.page_size, cfg.num_kv_heads, cfg.head_dim,
            bits)
    assert perf.kv_pool_bytes(*args, fp_bytes=fp) == live == \
        jperf.kv_pool_bytes(*args, fp_bytes=fp)


def test_h100_machine_balance_and_roofline_formula():
    """The H100 SXM's dense peaks (no TPU figure), and each site's time
    the larger of its bytes over the bandwidth and its ops over the peak
    of their unit; the step bound their sum."""
    assert (perf.HBM_BW, perf.PEAK_FLOPS, perf.INT8_OPS) == \
        (3.35e12, 989e12, 1979e12)
    costs = {"a": perf.qmm_cost("a", 4, 2048, 2048, 4, 128),
             "b": perf.fp_matmul_cost("b", 4096, 4096, 4096),
             "c": perf.paged_attention_cost("c", 4, 256, 8, 128, 16, 8, 16)}
    rl = perf.roofline(costs)
    step = 0.0
    for name, c in costs.items():
        mem = c.bytes / 3.35e12
        comp = c.fp_ops / 989e12 + c.int_ops / 1979e12
        row = rl["sites"][name]
        assert row["memory_s"] == pytest.approx(mem, rel=1e-12)
        assert row["compute_s"] == pytest.approx(comp, rel=1e-12)
        assert row["kernel_s"] == max(row["memory_s"], row["compute_s"])
        assert row["bound"] == ("memory" if mem >= comp else "compute")
        step += row["kernel_s"]
    assert rl["sites"]["b"]["bound"] == "compute"
    assert rl["sites"]["a"]["bound"] == "memory"
    assert rl["totals"]["step_time_s"] == pytest.approx(step, rel=1e-12)
    assert rl["totals"]["memory_bound_sites"] == 2
    # the same formula as the reference's, at the H100's balance
    jcosts = {k: jperf.KernelCost(*[getattr(c, f) for f in COST_FIELDS])
              for k, c in costs.items()}
    want = jperf.roofline(jcosts, perf.HBM_BW, perf.PEAK_FLOPS, perf.INT8_OPS)
    assert rl == want
    rows = perf.attribute(costs, decode_s=2.0)
    assert abs(sum(r.measured_ms for r in rows) - 2000.0) < 1e-6
    assert "more sites" in perf.format_table(rows, top=1)


def test_dispatch_timer_cadence_compile_split_and_device_time(monkeypatch):
    tr = Tracer(enabled=True)
    timer = perf.DispatchTimer(time_every=3)
    for i in range(7):
        span = DeviceSpan(torch.device("cpu"))
        if i == 0:                       # the library loaded in this dispatch
            monkeypatch.setattr(_build, "loads", _build.loads + 1)
        span.stop()
        dev_s, compiled = span.read()
        assert dev_s is None and compiled == (i == 0)
        timer.record("decode_burst", 0.01, tokens=4, compiled=compiled,
                     tracer=tr, device_s=0.004 if i % 2 else None)
    s = timer.summary()["decode_burst"]
    assert s["count"] == 7 and s["compiled"] == 1 and s["sampled"] == 3
    assert abs(s["wall_s"] - 0.07) < 1e-12
    assert abs(s["compile_s"] - 0.01) < 1e-12
    assert abs(s["exec_s"] - 0.06) < 1e-12
    assert s["device_timed"] == 3 and abs(s["device_s"] - 0.012) < 1e-12
    assert s["device_over_wall_max"] == pytest.approx(0.4)
    # the reference's summary keys, and the device ones beside them
    jt = jperf.DispatchTimer(1)
    jt.record("decode_burst", 0.01)
    assert set(jt.summary()["decode_burst"]) <= set(s)
    dev = [e for e in tr.chrome_trace()["traceEvents"]
           if e.get("tid") == DEVICE_TID and e.get("ph") == "X"]
    assert len(dev) == 3 and dev[0]["args"]["compiled"] is True
    assert [e["dur"] for e in dev] == pytest.approx([1e4, 4e3, 1e4])
    with pytest.raises(ValueError):
        perf.DispatchTimer(time_every=0)
    with pytest.raises(ValueError):
        ObsConfig(perf=True, time_every=0)


def test_profiled_engine_device_track_validates():
    cfg = dataclasses.replace(t_smoke("internlm2_1_8b"), scan_layers=False)
    qp, _ = quantize_params(init_params(cfg, seed=0, device="cpu"), 4,
                            group_size=8, device="cpu")
    ecfg = dict(max_slots=2, max_len=64, max_new_tokens=16, prefill_chunk=4,
                decode_burst=4, int8_compute=True, kv_cache="paged",
                page_size=8)
    assert Engine(qp, cfg, EngineConfig(**ecfg), device="cpu").perf is None
    assert Engine(qp, cfg, EngineConfig(**ecfg, obs=ObsConfig(trace=True)),
                  device="cpu").perf is None
    obs = ObsConfig(trace=True, device_metrics=True, perf=True, time_every=2,
                    drain_every=2)
    eng = Engine(qp, cfg, EngineConfig(**ecfg, obs=obs), device="cpu")
    fin, m = eng.run(trace_requests(cfg, [(0, 8, 5), (0, 12, 7), (3, 6, 4)]))
    trace = eng.tracer.chrome_trace()
    assert validate_chrome_trace(trace) == []
    dev = [e for e in trace["traceEvents"]
           if e.get("tid") == DEVICE_TID and e.get("ph") == "X"]
    assert {"device:prefill_chunk", "device:decode_burst"} <= \
        {e["name"] for e in dev}
    summ = eng.perf.summary()
    for kind in ("prefill_chunk", "decode_burst"):
        assert summ[kind]["sampled"] == -(-summ[kind]["count"] // 2)
        assert summ[kind]["compiled"] == 0            # the CPU loads nothing
    assert sum(e["dur"] for e in dev) <= \
        sum(st["wall_s"] for st in summ.values()) * 1e6 + 1.0
    assert summ["decode_burst"]["tokens"] == m.decode_tokens
    assert summ["drain"]["count"] >= 2


# ---------------------------------------------------------------------------
# bench history
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_history_round_trips_across_packages(tmp_path, writer):
    w, r = (history, jhist) if writer == "port" else (jhist, history)
    path = os.path.join(tmp_path, "BENCH_x.json")
    for i in range(5):
        w.append_run(path, "x", {"tok_per_s": 100.0 + 0.1 * i,
                                 "lat_us": 50.0 + 0.1 * i, "bad": float("nan")},
                     meta={"i": i}, now=1000.0 + i)
    hist = r.load_history(path)
    assert hist == w.load_history(path)
    assert hist["schema"] == history.HISTORY_SCHEMA == jhist.HISTORY_SCHEMA
    assert len(hist["runs"]) == 5 and hist["runs"][2]["meta"]["i"] == 2
    assert set(hist["runs"][0]["metrics"]) == {"tok_per_s", "lat_us"}
    for cand in ({"tok_per_s": 40.0, "lat_us": 500.0},
                 {"tok_per_s": 99.0, "lat_us": 52.0}, None):
        assert history.check_regression(hist, cand) == \
            jhist.check_regression(hist, cand)
    probs = history.check_regression(hist, {"tok_per_s": 40.0, "lat_us": 500.0})
    assert {p["metric"]: p["direction"] for p in probs} == \
        {"tok_per_s": "higher", "lat_us": "lower"}
    two = os.path.join(tmp_path, "BENCH_z.json")
    for i in range(2):
        w.append_run(two, "z", {"tok_per_s": 100.0}, now=float(i))
    assert history.check_regression(r.load_history(two), {"tok_per_s": 1.0}) == []
    bad = os.path.join(tmp_path, "BENCH_bad.json")
    with open(bad, "w") as f:
        f.write("{not json")
    assert history.load_history(bad)["runs"] == [] and \
        "note" in history.load_history(bad)


def test_metric_direction_conventions_equal_reference():
    for name in ("decode_tokens_per_s", "obs_on_over_off",
                 "kernel.qmm.ref_w4a8_us", "drain_s", "slot_occupancy",
                 "weight_bytes", "spec_speedup", "ttft_latency", "tps"):
        assert history.metric_direction(name) == jhist.metric_direction(name)
    assert history.metric_direction("drain_s") == "lower"
    assert history.metric_direction("slot_occupancy") == "both"


# ---------------------------------------------------------------------------
# the profiling CLI
# ---------------------------------------------------------------------------

def _reference_payload_keys():
    """The keys of the ``payload`` dict literal in the reference's
    ``profile``."""
    tree = ast.parse(inspect.getsource(jprofile.profile))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "payload"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no payload dict in repro.launch.profile.profile")


def test_profile_payload_and_sites_match_reference(tmp_path):
    tp, jp = tmp_path / "p.json", tmp_path / "t.json"
    payload = tprofile.profile(device="cpu", json_path=str(tp),
                               trace_path=str(jp))
    assert set(payload) == _reference_payload_keys()
    assert payload["schema"] == tprofile.PROFILE_SCHEMA == jprofile.PROFILE_SCHEMA
    assert validate_chrome_trace(json.loads(jp.read_text())) == []
    assert json.loads(tp.read_text())["sites"] == payload["sites"]
    assert payload["n_requests"] == 6
    assert set(payload["timing"]) >= {"prefill_chunk", "decode_burst", "drain"}
    # the same packed tree through the reference's cost model
    cfg = dataclasses.replace(t_smoke("internlm2_1_8b"), scan_layers=False)
    jcfg = dataclasses.replace(j_smoke("internlm2_1_8b"), scan_layers=False)
    qp, _ = quantize_params(init_params(cfg, seed=0, device="cpu"), 4,
                            group_size=8, device="cpu")
    jcosts = jperf.site_costs_from_tree(_to_jax(qp), 2, context=24 + 12 // 2,
                                        kv_bits=8, page_size=8, cfg=jcfg)
    want = {r.site: r for r in jperf.attribute(
        jcosts, 1.0, hbm_bw=perf.HBM_BW, peak_flops=perf.PEAK_FLOPS,
        int8_ops=perf.INT8_OPS)}
    rows = {r["site"]: r for r in payload["sites"]}
    assert set(rows) == set(want)
    assert set(next(iter(rows.values()))) == set(want["head"].as_dict())
    for site, r in rows.items():
        w = want[site]
        assert (r["kind"], r["bits"], r["bound"]) == (w.kind, w.bits, w.bound)
        assert r["predicted_bytes"] == w.predicted_bytes, site
        assert r["byte_share"] == pytest.approx(w.byte_share, rel=1e-12)
        assert r["time_share"] == pytest.approx(w.time_share, rel=1e-12)
        assert r["fit"] is None or np.isfinite(r["fit"])
    for site, c in jcosts.items():
        if c.kind == "qmm":
            leaf = qp
            for key in site.split("/"):
                leaf = leaf[key]
            assert c.bytes_weight == tq.storage_summary([leaf])["packed_bytes"]
