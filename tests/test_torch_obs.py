"""The port's observability (``repro_torch.obs``) against the reference's
(``repro.obs``) on the CPU, on the smoke ``internlm2_1_8b`` engine the
reference's own obs tests serve (W4, group 8, ``int8_compute``, paged
with page 8) and their staggered ``TRACE`` schedule (queueing,
mid-flight admission, eviction and backfill):

  * the counter registry and its two flat buffers;
  * drained counters == the host bookkeeping, exactly, and == the JAX
    engine's on the same requests (int32 counters and call counts
    exactly; the clip and read statistics within a stated tolerance);
  * obs off: no counters, no drains, and a decode burst with counters
    on reads no scalar back over obs off (``TorchDispatchMode``);
  * tp=2 on a CPU mesh == tp=1, totals and streams, bit for bit;
  * speculative tallies against a host recount and the JAX engine;
  * the Chrome trace under both validators, its span names and request
    nesting as the reference's, the event log;
  * Prometheus text byte-equal to the reference's, the parse round trip
    and the endpoint; snapshot keys as the reference's;
  * the four stats hooks == the reference's; the drift monitor quiet in
    calibration, flagging stale calibration, its site KLs == the
    reference's on the same live state.

The JAX engine runs once per module (``REPRO_KERNELS=ref``)."""
import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import obs as jobs
from repro.configs import smoke_config as j_smoke
from repro.kernels import fake_quant as jfq
from repro.kernels import int8_matmul as jint8
from repro.kernels import paged_attention as jpa
from repro.kernels import qmm as jqmm
from repro.models.transformer import init_params as j_init
from repro.obs.drift import DriftMonitor as JDriftMonitor
from repro.obs.gauges import snapshot as j_snapshot
from repro.serve.engine import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serve.spec import SpecConfig as JSpecConfig
from repro_torch import obs
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import fake_quant as tfq
from repro_torch.kernels import int8_matmul as tint8
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import qmm as tqmm
from repro_torch.launch.mesh import make_tp_mesh
from repro_torch.models.context import CollectContext
from repro_torch.models.transformer import forward
from repro_torch.obs.drift import DriftMonitor
from repro_torch.obs.gauges import snapshot
from repro_torch.serve import engine as tengine
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.loadgen import trace_requests
from repro_torch.serve.quantized import quantize_params
from repro_torch.serve.spec import SpecConfig
from repro_torch.utils.pytree import named_leaves
from test_torch_tp import _to_jax
from _torch_threads import _one_thread  # noqa: F401

TRACE = [(0, 8, 5), (0, 12, 7), (3, 6, 4), (10, 10, 6), (11, 5, 8)]
ECFG = dict(max_slots=2, max_len=64, max_new_tokens=16, prefill_chunk=4,
            decode_burst=4, int8_compute=True, kv_cache="paged", page_size=8)
# clip statistics on every burst: every counter is compared on every
# burst, and the JAX engines compile one burst flavor, not two
OBS = dict(trace=True, device_metrics=True, drain_every=2, stats_every=1)
SPEC_TRACE = TRACE[:3]
# exact: int32 counters and call/element counts. Within 2% relative: the
# saturated-activation count (a value on a rounding boundary of the
# per-row int8 grid may land one grid step apart in fp32 sums run in
# another order) and the fp32 read/clip sums
EXACT_F32 = ("qmm_calls", "int8mm_calls", "act_elems", "fq_elems",
             "paged_calls", "moe_dropped_tokens")
CLOSE_F32 = ("act_sat", "paged_tokens_read", "fq_clip")
# the gauges of each package with no counterpart in the other (ROADMAP
# § C, differences by design): the reference's jit-cache sizes, the
# port's kernel-library loads (and, on the card, allocated bytes)
REF_ONLY = {"jit_cache_engine_step", "jit_cache_prefill"}
PORT_ONLY = {"kernel_lib_loads", "device_allocated_bytes"}


def _streams(fin):
    return [np.asarray(r.output_tokens).tolist() for r in fin]


def _reqs(cfg, trace=TRACE):
    return trace_requests(cfg, trace)


@pytest.fixture(scope="module")
def models():
    """JAX and port trees of the same fp weights and the same W4 bytes."""
    jcfg = dataclasses.replace(j_smoke("internlm2_1_8b"), scan_layers=False)
    jp = jax.jit(lambda key: j_init(jcfg, key))(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tqp, _ = quantize_params(tp, 4, group_size=8, device="cpu")
    tcfg = dataclasses.replace(t_smoke("internlm2_1_8b"), scan_layers=False)
    return jcfg, jp, _to_jax(tqp), tcfg, tp, tqp


def _weight_sites(tp):
    return [n for n, leaf in named_leaves(tp) if leaf.ndim == 2]


def _tap_site_kls(mon, sites, out):
    """Measure ``site_kls`` at the monitor's first sampling tap, on the
    live state (slots mid-decode with KV history)."""
    orig = mon._sample

    def tap(slot):
        if not out:
            out.update(mon.site_kls(sites, bits=4))
        orig(slot)

    mon._sample = tap


@pytest.fixture(scope="module")
def ref_run(models):
    """The JAX engine with tracing, counters and a self-calibrating drift
    monitor over TRACE; its spec engine over SPEC_TRACE."""
    jcfg, jp, jqp, _, tp, _ = models
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_KERNELS", "ref")
        eng = JEngine(jqp, jcfg, JEngineConfig(**ECFG, obs=jobs.ObsConfig(**OBS)))
        mon = JDriftMonitor(jp, _calibrated_ranges(models[3], tp),
                            every=4).attach(eng)
        kls = {}
        _tap_site_kls(mon, _weight_sites(tp), kls)
        spec = JEngine(jqp, jcfg, JEngineConfig(
            **ECFG, spec=JSpecConfig(k=3),
            obs=jobs.ObsConfig(device_metrics=True, drain_every=2,
                               stats_every=1)))
        # compile lazily, only the burst shapes these schedules dispatch
        # (the engines' warmup compiles every power-of-two burst twice)
        eng._warmed_modes = spec._warmed_modes = {"greedy"}
        fin, m = eng.run(_reqs(jcfg))
        sfin, _ = spec.run(_reqs(jcfg, SPEC_TRACE))
    return dict(engine=eng, streams=_streams(fin), totals=eng.counters.totals(),
                trace=eng.tracer.chrome_trace(), snapshot=j_snapshot(eng),
                kls=kls, drift=mon.drift_report(), metrics=m,
                spec_totals=spec.counters.totals(), spec_streams=_streams(sfin))


@pytest.fixture(scope="module")
def port_run(models):
    _, _, _, tcfg, tp, tqp = models
    eng = Engine(tqp, tcfg, EngineConfig(**ECFG, obs=obs.ObsConfig(**OBS)),
                 device="cpu")
    mon = DriftMonitor(tp, _calibrated_ranges(tcfg, tp), every=4).attach(eng)
    kls = {}
    _tap_site_kls(mon, _weight_sites(tp), kls)
    fin, m = eng.run(_reqs(tcfg))
    return dict(engine=eng, streams=_streams(fin), fin=fin, metrics=m,
                totals=eng.counters.totals(), kls=kls,
                drift=mon.drift_report())


def _plain_streams(tcfg, tqp, mesh=None, obs_cfg=None):
    eng = Engine(tqp, tcfg, EngineConfig(**ECFG, mesh=mesh, obs=obs_cfg),
                 device=None if mesh else "cpu")
    fin, _ = eng.run(_reqs(tcfg))
    return eng, _streams(fin)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

def test_counter_registry_equals_reference_and_packs_flat():
    from repro.obs import runtime as jrt
    from repro_torch.obs import runtime as trt
    assert list(trt.COUNTERS) == list(jrt.COUNTERS)
    for name, spec in trt.COUNTERS.items():
        want = jrt.COUNTERS[name]
        assert (spec.kind, spec.shape) == (want.kind, want.shape), name
    assert trt.HIST_BUCKETS == jrt.HIST_BUCKETS == 8
    ctr = obs.init_counters("cpu")
    jctr = jobs.init_counters()
    assert set(ctr) == {"i32", "f32"}
    assert ctr["i32"].dtype == torch.int32 and ctr["f32"].dtype == torch.float32
    for kind in ("i32", "f32"):
        assert ctr[kind].ndim == 1 and ctr[kind].shape == jctr[kind].shape
    assert obs.ctr_get(ctr, "burst_size_hist").shape == (8,)
    assert obs.ctr_get(ctr, "decode_tokens").dtype == torch.int32
    assert obs.ctr_get(ctr, "qmm_calls").dtype == torch.float32
    host = obs.runtime.init_host_counters()
    assert {k: v.shape for k, v in host.items()} == \
        {k: tuple(v.shape) for k, v in ctr.items()}
    # the packed layout addresses the same slices in both packages
    obs.ctr_add(ctr, "burst_size_hist", torch.tensor(3), idx=5)
    obs.ctr_add(ctr, "act_sat", torch.tensor(2.5))
    jctr = jobs.ctr_add(jobs.ctr_add(jctr, "burst_size_hist", 3, idx=5),
                        "act_sat", 2.5)
    for kind in ("i32", "f32"):
        np.testing.assert_array_equal(ctr[kind].numpy(), np.asarray(jctr[kind]))
    with pytest.raises(KeyError, match="unregistered"):
        obs.CounterSink().add("nope", 1.0)
    dc = obs.DeviceCounters()
    assert dc.drain({}) == {} and dc.totals() == {}


def test_sink_routes_host_numbers_and_device_tensors():
    """Python numbers are summed on the host; tensors are kept as they
    are emitted and ``fold`` adds each counter's sum to the device buffer
    (the host sums to the host half); the drain adds both halves."""
    ctr, host = obs.init_counters("cpu"), obs.runtime.init_host_counters()
    sink = obs.CounterSink(stats=True)
    with obs.collecting(sink):
        assert obs.emitting() and obs.emitting_stats()
        obs.emit("qmm_calls", 1.0)
        obs.emit("qmm_calls", 1.0)
        obs.emit("act_sat", torch.tensor([1.0, 2.0]))
        obs.emit("act_sat", torch.tensor(0.5))
        obs.emit("decode_tokens", torch.tensor(3))
        with obs.suspended():
            assert not obs.emitting()
            obs.emit("qmm_calls", 1.0)
    assert not obs.emitting()
    obs.emit("qmm_calls", 1.0)                    # no sink: a no-op
    assert sink.sums == {"qmm_calls": 2.0}
    assert float(obs.ctr_get(ctr, "act_sat")) == 0.0
    obs.fold(ctr, sink, host)
    assert sink.sums == {} and sink.tensors == {}
    assert float(obs.ctr_get(ctr, "act_sat")) == 3.5
    assert int(obs.ctr_get(ctr, "decode_tokens")) == 3
    assert float(obs.ctr_get(ctr, "qmm_calls")) == 0.0      # host-known
    dc = obs.DeviceCounters()
    t = (dc.drain(ctr, host), dc.totals())[1]
    assert t["qmm_calls"] == 2.0 and t["act_sat"] == 3.5
    assert t["decode_tokens"] == 3 and dc.n_drains == 1
    cheap = obs.CounterSink(stats=False)
    with obs.collecting(cheap):
        assert obs.emitting() and not obs.emitting_stats()


def test_device_counter_drain_parity(port_run):
    """Drained counters == the host bookkeeping (numpy slot mirrors),
    exactly: two bookkeepers closing the same ledger."""
    eng, m = port_run["engine"], port_run["metrics"]
    assert len(port_run["fin"]) == len(TRACE)
    t = port_run["totals"]
    assert t["decode_tokens"] == m.decode_tokens
    assert t["decode_steps"] == m.decode_steps
    assert sum(t["burst_size_hist"]) == t["decode_bursts"] > 0
    assert t["qmm_calls"] > 0 and t["act_elems"] > 0
    assert t["paged_calls"] > 0 and t["paged_tokens_read"] > 0
    assert 0.0 <= t["fq_clip"] <= t["fq_elems"]
    assert eng.counters.n_drains >= 2
    assert 0.0 <= eng.counters.rates()["act_clip_rate"] <= 1.0


def test_totals_equal_reference_engine(port_run, ref_run):
    assert port_run["streams"] == ref_run["streams"]
    got, want = port_run["totals"], ref_run["totals"]
    assert set(got) == set(want)
    for name, spec in obs.COUNTERS.items():
        if spec.kind == "i32":
            assert got[name] == want[name], name
        elif name in EXACT_F32:
            assert got[name] == want[name], name
        else:
            assert name in CLOSE_F32
            assert got[name] == pytest.approx(want[name], rel=0.02, abs=1e-6), name
    assert port_run["engine"].counters.n_drains == \
        ref_run["engine"].counters.n_drains


class _ScalarReads(TorchDispatchMode):
    """Counts the ops that read a tensor's value back to the host."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _burst_scalar_reads(tcfg, tqp, obs_cfg):
    eng = Engine(tqp, tcfg, EngineConfig(**ECFG, obs=obs_cfg), device="cpu")
    orig, counts = eng._burst, []

    def counted(steps):
        with _ScalarReads() as mode:
            orig(steps)
        counts.append(mode.n)

    eng._burst = counted
    fin, _ = eng.run(_reqs(tcfg, SPEC_TRACE))
    return eng, counts, _streams(fin)


def test_obs_off_no_counters_and_no_scalar_reads_added(models, port_run):
    """obs=None: no counter buffer, empty totals, no drains. With
    counters on (clip statistics every burst) each decode burst reads
    back exactly as many scalars as with obs off, and the streams equal
    the obs-off engine's."""
    _, _, _, tcfg, _, tqp = models
    off, n_off, s_off = _burst_scalar_reads(tcfg, tqp, None)
    assert off._fresh_counters() == {}
    assert off.counters.totals() == {} and off.counters.n_drains == 0
    assert off.tracer.n_events == 0 and off.perf is None
    on, n_on, s_on = _burst_scalar_reads(
        tcfg, tqp, obs.ObsConfig(device_metrics=True, stats_every=1,
                                 drain_every=1))
    assert s_on == s_off == port_run["streams"][:len(SPEC_TRACE)]
    assert len(n_on) == len(n_off) > 0 and n_on == n_off
    assert on.counters.n_drains >= 2


def test_tp2_totals_and_streams_equal_tp1(models, port_run):
    """Emits come from the replicated pre-shard values and the per-shard
    calls are suspended, so tp=2 drains tp=1's counters bit for bit."""
    _, _, _, tcfg, _, tqp = models
    eng, streams = _plain_streams(tcfg, tqp, mesh=make_tp_mesh(2, "cpu"),
                                  obs_cfg=obs.ObsConfig(**OBS))
    assert eng._shard_plan and eng._kv_shards == 2
    assert streams == port_run["streams"]
    assert eng.counters.totals() == port_run["totals"]


def test_spec_tallies_against_host_recount_and_reference(models, ref_run,
                                                         monkeypatch):
    """``spec_proposed`` / ``spec_accepted`` equal a host recount of every
    dispatch's active slots and matched prefixes, and the JAX engine's."""
    _, _, _, tcfg, _, tqp = models
    recount = {"proposed": 0, "accepted": 0}
    accept = tengine.accept_drafts

    def spy(drafts, targets, active, nwritten, budget):
        n_emit, n_match = accept(drafts, targets, active, nwritten, budget)
        act = active.numpy()
        recount["proposed"] += drafts.shape[1] * int(act.sum())
        recount["accepted"] += int(n_match.numpy()[act].sum())
        return n_emit, n_match

    monkeypatch.setattr(tengine, "accept_drafts", spy)
    eng = Engine(tqp, tcfg, EngineConfig(
        **ECFG, spec=SpecConfig(k=3),
        obs=obs.ObsConfig(device_metrics=True, drain_every=2,
                          stats_every=1)), device="cpu")
    fin, m = eng.run(_reqs(tcfg, SPEC_TRACE))
    t = eng.counters.totals()
    assert _streams(fin) == ref_run["spec_streams"]
    assert t["spec_proposed"] == recount["proposed"] == eng.spec_stats["proposed"]
    assert t["spec_accepted"] == recount["accepted"] > 0
    assert t["spec_accepted"] >= eng.spec_stats["accepted"]
    assert t["decode_tokens"] == m.decode_tokens
    for name in ("spec_proposed", "spec_accepted", "decode_tokens",
                 "decode_steps", "decode_bursts", "burst_size_hist"):
        assert t[name] == ref_run["spec_totals"][name], name


# ---------------------------------------------------------------------------
# span tracing
# ---------------------------------------------------------------------------

def _tracks(trace):
    by_tid = {}
    for e in trace["traceEvents"]:
        if e.get("ph") == "X":
            by_tid.setdefault(e["tid"], []).append(e)
    return by_tid


def _shape(trace):
    """Span names per track, request tracks keyed by their request."""
    out = {}
    for tid, evs in _tracks(trace).items():
        names = sorted(e["name"] for e in evs)
        req = [n for n in names if n.startswith("request")]
        out[req[0] if req else tid] = names
    return out


def test_trace_validates_and_matches_reference(port_run, ref_run, tmp_path):
    eng = port_run["engine"]
    obj = eng.tracer.chrome_trace()
    assert obs.validate_chrome_trace(obj) == []
    assert jobs.validate_chrome_trace(obj) == []
    names = {e["name"] for e in obj["traceEvents"] if e.get("ph") == "X"}
    for want in ("run", "admit", "prefill_chunk", "decode_burst", "drain",
                 "evict"):
        assert want in names, (want, names)
    # the same spans on the same tracks as the reference's trace
    assert _shape(obj) == _shape(ref_run["trace"])
    req_tracks = [evs for evs in _tracks(obj).values()
                  if any(e["name"].startswith("request") for e in evs)]
    assert len(req_tracks) == len(TRACE)
    for evs in req_tracks:
        req = next(e for e in evs if e["name"].startswith("request"))
        lo, hi = req["ts"], req["ts"] + req["dur"]
        for e in evs:
            assert lo - 1e-6 <= e["ts"] and e["ts"] + e["dur"] <= hi + 1e-6
    p = tmp_path / "trace.json"
    eng.tracer.write(str(p))
    assert jobs.validate_chrome_trace(json.loads(p.read_text())) == []
    ep = tmp_path / "events.jsonl"
    eng.tracer.write_events(str(ep))
    kinds = [json.loads(line)["kind"] for line in ep.read_text().splitlines()]
    assert kinds.count("admit") == kinds.count("finish") == len(TRACE)


def test_validate_and_disabled_tracer():
    assert obs.validate_chrome_trace([]) != []
    overlap = {"traceEvents": [
        {"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": 0.0, "dur": 10.0},
        {"ph": "X", "name": "b", "pid": 1, "tid": 1, "ts": 5.0, "dur": 10.0}]}
    assert any("nest" in p for p in obs.validate_chrome_trace(overlap))
    assert obs.validate_chrome_trace(overlap) == \
        jobs.validate_chrome_trace(overlap)
    tr = obs.Tracer(enabled=False)
    tr.end(tr.begin("x"))
    tr.event("admit", req=1)
    with tr.span("y"):
        pass
    assert tr.n_events == 0 and tr.chrome_trace()["traceEvents"] == []


# ---------------------------------------------------------------------------
# exposition and gauges
# ---------------------------------------------------------------------------

def test_render_byte_equal_parse_and_endpoint(port_run):
    eng = port_run["engine"]
    snap = snapshot(eng)
    samples = dict(snap, flag=True, skipped=None, **{"bad name-1": 7})
    assert obs.render(samples, obs.GAUGE_HELP) == \
        jobs.render(samples, obs.GAUGE_HELP)
    assert obs.parse(obs.render(samples)) == jobs.parse(obs.render(samples))
    assert snap["ctr_decode_tokens"] == eng.metrics.decode_tokens
    srv = obs.MetricsServer(0, lambda: snapshot(eng))
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics") as r:
            body = r.read().decode()
    finally:
        srv.close()
    assert obs.parse(body)[("repro_ctr_decode_tokens", "")] == \
        eng.metrics.decode_tokens
    with pytest.raises(ValueError):
        obs.parse("not a metric line at all\n")


def test_snapshot_keys_match_reference(port_run, ref_run, tmp_path):
    got = set(snapshot(port_run["engine"]))
    want = set(ref_run["snapshot"])
    assert got - PORT_ONLY == want - REF_ONLY
    assert "kernel_lib_loads" in got and "weight_bytes_per_shard" in got
    p = tmp_path / "m.prom"
    obs.write_snapshot(str(p), snapshot(port_run["engine"]))
    assert json.loads((tmp_path / "m.prom.json").read_text())[
        "ctr_decode_tokens"] == port_run["metrics"].decode_tokens


# ---------------------------------------------------------------------------
# the stats hooks
# ---------------------------------------------------------------------------

def test_stats_hooks_equal_reference():
    rng = np.random.default_rng(0)
    xq = rng.integers(-128, 128, size=(7, 33)).astype(np.int8)
    xq[0, :5] = 127
    xq[1, :3] = -127
    for t_fn, j_fn in ((tqmm.saturation_stats, jqmm.saturation_stats),
                       (tint8.activation_saturation,
                        jint8.activation_saturation)):
        sat, total = t_fn(torch.from_numpy(xq))
        jsat, jtotal = j_fn(jnp.asarray(xq))
        assert float(sat) == float(jsat) and total == float(jtotal)
    pos = rng.integers(0, 300, size=(5,)).astype(np.int32)
    assert float(tpa.read_token_stats(torch.from_numpy(pos))) == \
        float(jpa.read_token_stats(jnp.asarray(pos)))
    x = (rng.normal(size=(6, 40)) * 3).astype(np.float32)
    for scale, zp, bits, levels in ((0.05, 128.0, 8, None), (0.3, 7.0, 4, None),
                                    (0.02, 0.0, 8, 254)):
        c, total = tfq.clip_stats(torch.from_numpy(x), scale, zp, bits, levels)
        jc, jtotal = jfq.clip_stats(jnp.asarray(x), scale, zp, bits, levels)
        assert float(c) == float(jc) > 0 and total == float(jtotal)


# ---------------------------------------------------------------------------
# the FIT drift monitor
# ---------------------------------------------------------------------------

def _calibrated_ranges(cfg, fp_params):
    """Per-site (lo, hi) from one fp forward over a calibration batch."""
    from repro_torch.data.synthetic import LMStreamConfig, lm_batches
    from repro_torch.core.report import to_device_batch
    stream = lm_batches(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                       global_batch=4, seed=1))
    ctx = CollectContext()
    with torch.no_grad():
        forward(fp_params, to_device_batch(next(stream), "cpu"), cfg, ctx=ctx)
    return {k: (min(float(a.min()), 0.0), max(float(a.max()), 0.0))
            for k, a in ctx.acts.items()}


def test_drift_quiet_in_calibration(port_run, ref_run):
    """port_run's monitor: calibrated on an fp forward over a calibration
    batch; its probes (which write the probed token's K/V in place)
    change no served token."""
    assert port_run["streams"] == ref_run["streams"]
    rep = port_run["drift"]
    assert rep["n_samples"] >= 2
    assert rep["in_calibration"] and rep["flagged_sites"] == []
    assert rep["kl_max"] is not None and rep["kl_max"] >= 0.0


def test_drift_flags_stale_calibration(models, port_run):
    _, _, _, tcfg, tp, tqp = models
    eng = Engine(tqp, tcfg, EngineConfig(**ECFG), device="cpu")
    mon = DriftMonitor(tp, {}, every=4, ratio_threshold=1.5,
                       calibration_scale=1.0 / 3.0).attach(eng)
    fin, _ = eng.run(_reqs(tcfg))
    assert _streams(fin) == port_run["streams"]
    rep = mon.drift_report()
    assert not rep["in_calibration"] and rep["flagged_sites"]
    assert rep["flagged_layers"]
    assert all(layer.startswith("layers/") for layer in rep["flagged_layers"])
    assert [s for s, d in rep["sites"].items() if d["flagged"]] == \
        rep["flagged_sites"]
    assert max(d["max_ratio"] for d in rep["sites"].values()) > 1.5


def test_drift_site_kls_and_report_match_reference(port_run, ref_run):
    """Measured at the first sampling tap of the same schedule, on each
    engine's live state (the same tokens and KV history): every 2-D
    block's online KL within 5% relative + 1e-6 absolute of the
    reference's (the KLs span ~1e-7..3e-4; an fp32 log-softmax KL of two
    near-equal distributions carries ~5e-7 of rounding, and the KV pages
    hold the same tokens' int8 K/V up to one grid step). (The
    reference's own Spearman-vs-FIT test fails under the installed JAX;
    ROADMAP § C.)"""
    got, want = port_run["kls"], ref_run["kls"]
    assert set(got) == set(want) and len(got) >= 15
    for site, v in want.items():
        assert got[site] == pytest.approx(v, rel=0.05, abs=1e-6), site
    a, b = port_run["drift"], ref_run["drift"]
    assert set(a) == set(b) and set(a["sites"]) == set(b["sites"])
    for key in ("n_samples", "every", "ratio_threshold", "flagged_sites",
                "flagged_layers", "in_calibration"):
        assert a[key] == b[key], key
    assert a["kl_mean"] == pytest.approx(b["kl_mean"], rel=0.05, abs=1e-7)
    for site, d in b["sites"].items():
        assert a["sites"][site]["max_ratio"] == pytest.approx(
            d["max_ratio"], rel=1e-3), site
