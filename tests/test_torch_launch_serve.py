"""The port's serving CLI (``repro_torch.launch.serve``) against
``repro.launch.serve`` on the CPU at smoke size: PTQ pinning, closed-loop
``generated`` equal to the reference's on the int8-backed paged route
with a shared prefix, the recurrent families (zamba2 paged, mamba2 on
its dense state, paged mamba2 refused), the speculative and sampling
flags at smoke size,
the observability flags (their sections with the reference's keys), the
GPU default, and ``main()``'s JSON dump."""
import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.launch import serve as jserve
from repro.models.transformer import init_params as j_init
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models.transformer import init_params as t_init
from repro_torch.quant.policy import QuantPolicy
from repro_torch.serve import SamplingParams
from repro_torch.utils.pytree import named_leaves


def _ref_params(arch):
    """The reference serve()'s own params (seed 0, unrolled), as the port's
    tree on the CPU."""
    jcfg = dataclasses.replace(j_smoke(arch), scan_layers=False)
    jp = j_init(jcfg, jax.random.key(0))
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def test_quantize_weights_pins_match_policy():
    """Serving PTQ and MPQ search share one pinning rule (QuantPolicy);
    the fake-quantized values equal the reference's."""
    arch = "deepseek_moe_16b"                       # has router + gate blocks
    params = t_init(t_smoke(arch), seed=0, device="cpu")
    policy = QuantPolicy()
    qp = tserve.quantize_weights(params, 4, policy)
    n_changed = 0
    for (name, before), (_, after) in zip(named_leaves(params),
                                          named_leaves(qp)):
        changed = not torch.equal(before, after)
        n_changed += changed
        if changed:
            assert policy.quantizable(name, before.ndim), name
        if policy.is_pinned(name):
            assert not changed, f"pinned block {name} was quantized"
    assert n_changed > 0
    jp = j_init(j_smoke(arch), jax.random.key(0))
    want = jserve.quantize_weights(jp, 4)
    got = tserve.quantize_weights(
        params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), 4)
    for (name, a), (_, b) in zip(named_leaves(got),
                                 named_leaves(jax.tree.map(np.asarray, want))):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("spec", [
    dict(bits=4), dict(bits=3, symmetric=True), dict(bits=8, channel_axis=-1),
    dict(bits=6, symmetric=True, channel_axis=0), dict(bits=16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_ref_matches_reference(spec, dtype):
    """The fp fake-quant behind ``--weight-bits`` alone, in the input's
    dtype as the reference computes it: equal values."""
    import jax.numpy as jnp
    from repro.quant.quantizer import QuantSpec as JSpec, fake_quant_ref as jfq
    from repro_torch.quant.quantizer import QuantSpec, fake_quant_ref
    x = np.random.default_rng(0).normal(size=(24, 40)).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jfq(jx, JSpec(**spec)).astype(jnp.float32))
    got = fake_quant_ref(tx, QuantSpec(**spec))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_to_qtensor_round_trip_equals_fake_quant():
    """Symmetric per-tensor storage holds exactly the values symmetric
    fake-quant simulates; per-channel specs need the channel last."""
    from repro_torch.quant.quantizer import (
        QuantSpec, fake_quant_ref, from_qtensor, to_qtensor)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(32, 16))
                         .astype(np.float32))
    for bits in (8, 6, 4, 3):
        spec = QuantSpec(bits=bits, symmetric=True)
        assert torch.equal(from_qtensor(to_qtensor(x, spec)), fake_quant_ref(x, spec))
    with pytest.raises(ValueError, match="symmetric"):
        to_qtensor(x, QuantSpec(bits=4))
    with pytest.raises(ValueError, match="LAST"):
        to_qtensor(x, QuantSpec(bits=4, symmetric=True, channel_axis=0))


KW = dict(batch=3, prompt_len=30, gen_len=6, weight_bits=None, int8=True,
          int8_compute=True, paged=True, page_size=16, kv_bits=8,
          shared_prefix=24)


def test_serve_closed_loop_matches_reference(monkeypatch):
    """--int8 --int8-compute --paged --kv-bits 8 --shared-prefix 24 on the
    smoke config: the same generated matrix as the reference's serve(),
    with the same prefix sharing and copy-on-write counts."""
    arch = "internlm2_1_8b"
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    tp = _ref_params(arch)
    monkeypatch.setattr(tserve, "init_params", lambda cfg, seed=0, device=None: tp)
    want = jserve.serve(arch, True, **KW)
    got = tserve.serve(arch, True, **KW, device="cpu")
    assert got["generated"].shape == (3, 6)
    np.testing.assert_array_equal(got["generated"], np.asarray(want["generated"]))
    for key in ("kv_shared_tokens", "kv_cow_copies", "n_finished",
                "decode_tokens", "kv_peak_pages"):
        assert got["metrics"][key] == want["metrics"][key], key
    assert got["metrics"]["kv_shared_tokens"] > 0
    assert got["metrics"]["kv_cow_copies"] > 0


RECURRENT_KW = dict(batch=3, prompt_len=12, gen_len=6, weight_bits=None,
                    int8_compute=True)


@pytest.mark.parametrize("arch, kw", [
    ("zamba2_7b", dict(packed=True, paged=True, kv_bits=8)),
    ("mamba2_130m", dict(int8=True))])
@pytest.mark.usefixtures("one_thread")
def test_serve_recurrent_families_match_reference(arch, kw, monkeypatch):
    """The recurrent families through the CLI: zamba2 packed on paged
    8-bit KV, mamba2 int8 on its dense per-slot state; the same generated
    matrix as the reference's serve()."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    tp = _ref_params(arch)
    monkeypatch.setattr(tserve, "init_params", lambda cfg, seed=0, device=None: tp)
    want = jserve.serve(arch, True, **RECURRENT_KW, **kw)
    got = tserve.serve(arch, True, **RECURRENT_KW, **kw, device="cpu")
    assert got["generated"].shape == (3, 6)
    np.testing.assert_array_equal(got["generated"], np.asarray(want["generated"]))
    assert got["metrics"]["n_finished"] == want["metrics"]["n_finished"] == 3


# on RECURRENT_KW's shape (int8_compute on)
FAMILY_ROUTES = {
    "packed_paged8": dict(packed=True, paged=True, kv_bits=8),
    "int8": dict(int8=True),
    "spec3_w4": dict(packed=True, paged=True, kv_bits=8, spec_k=3,
                     spec_bits="4"),
    "sampled": dict(packed=True, paged=True, kv_bits=8, sampling=(0.8, 5, 0.9)),
}


@pytest.mark.parametrize("route", sorted(FAMILY_ROUTES))
@pytest.mark.parametrize("arch", ["musicgen_large", "phi3_vision_4_2b"])
@pytest.mark.usefixtures("one_thread")
def test_serve_audio_vlm_families_match_reference(arch, route, monkeypatch):
    """The audio and vlm families through the CLI on four routes: packed
    on paged 8-bit KV, int8-backed, speculative (k = 3, a 4-bit draft)
    and sampled (T 0.8, top-k 5, top-p 0.9): the same generated matrix
    (musicgen's (B, G, CB) grids), finished count, decode tokens and
    peak pages as the reference's serve()."""
    from repro.serve import SamplingParams as JSamplingParams
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    tp = _ref_params(arch)
    monkeypatch.setattr(tserve, "init_params", lambda cfg, seed=0, device=None: tp)
    jkw, tkw = dict(FAMILY_ROUTES[route]), dict(FAMILY_ROUTES[route])
    if "sampling" in jkw:
        t, k, p = jkw.pop("sampling")
        jkw["sampling"] = JSamplingParams(temperature=t, top_k=k, top_p=p, seed=3)
        tkw["sampling"] = SamplingParams(temperature=t, top_k=k, top_p=p, seed=3)
    want = jserve.serve(arch, True, **RECURRENT_KW, **jkw)
    got = tserve.serve(arch, True, **RECURRENT_KW, **tkw, device="cpu")
    assert got["generated"].shape[:2] == (3, 6)
    np.testing.assert_array_equal(got["generated"], np.asarray(want["generated"]))
    for key in ("n_finished", "decode_tokens", "kv_peak_pages"):
        assert got["metrics"][key] == want["metrics"][key], key


def test_serve_refuses_paged_ssm_like_reference():
    """--paged on the ssm family: refused, as by the reference."""
    with pytest.raises(ValueError) as want:
        jserve.serve("mamba2_130m", True, **RECURRENT_KW, paged=True)
    with pytest.raises(ValueError) as got:
        tserve.serve("mamba2_130m", True, **RECURRENT_KW, paged=True,
                     device="cpu")
    assert str(got.value) == str(want.value)


def test_serve_open_loop_moe_packed():
    """The MoE family through the CLI: packed W8 expert stacks on the
    grouped route, open-loop Poisson arrivals, every request finished."""
    out = tserve.serve("olmoe_1b_7b", True, 2, 12, 6, None, packed=True,
                       int8_compute=True, n_requests=3, rate=0.5, paged=True,
                       shared_prefix=8, device="cpu")
    assert "generated" not in out
    assert out["metrics"]["n_finished"] == 3
    for r in out["requests"]:
        assert r.num_generated == r.max_new_tokens
        assert ((r.output_tokens >= 0) & (r.output_tokens < 256)).all()


def _reference_observability_keys():
    """The keys of the reference serve()'s ``out["observability"]`` dict."""
    import ast
    import inspect
    for node in ast.walk(ast.parse(inspect.getsource(jserve.serve))):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and isinstance(node.targets[0], ast.Subscript)
                and getattr(node.targets[0].slice, "value", None)
                == "observability"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no observability dict in repro.launch.serve.serve")


# each observability flag, with the flag that turns its section on where
# it does not on its own (as in the reference: --drain-every only paces
# the counters, --drift-stale / --drift-threshold only tune the monitor)
OBS_FLAGS = {
    "trace_path": dict(trace_path="t.json"),
    "events_path": dict(events_path="e.jsonl"),
    "metrics_file": dict(metrics_file="m.prom"),
    "metrics_port": dict(metrics_port=0),
    "drain_every": dict(drain_every=1, events_path="e.jsonl"),
    "drift_every": dict(drift_every=1),
    "drift_stale": dict(drift_stale=3.0, drift_every=2),
    "drift_threshold": dict(drift_threshold=2.0, drift_every=2),
}


@pytest.mark.parametrize("flag", sorted(OBS_FLAGS))
def test_observability_flags_run(flag, tmp_path, monkeypatch):
    """Each of the eight observability flags runs ``serve()``: the
    ``observability`` and ``drift`` sections carry the reference's keys;
    the files are written; a drain cadence of 1 drains every burst."""
    from repro.obs.drift import DriftMonitor as JDriftMonitor
    monkeypatch.chdir(tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tserve.serve("internlm2_1_8b", True, 2, 8, 4, None, packed=True,
                           int8_compute=True, paged=True, device="cpu",
                           **OBS_FLAGS[flag])
    finally:
        torch.set_num_threads(n)
    kw = OBS_FLAGS[flag]
    assert ("observability" in out) == ("drift_every" not in kw)
    assert ("drift" in out) == ("drift_every" in kw)
    if "observability" in out:
        ob = out["observability"]
        assert set(ob) == _reference_observability_keys()
        assert ob["counters"]["decode_tokens"] == out["metrics"]["decode_tokens"]
        # a drain every drain_every bursts, and one at the end
        every = kw.get("drain_every", 8)
        assert ob["counter_drains"] == \
            ob["counters"]["decode_bursts"] // every + 1
    if "drift" in out:
        assert set(out["drift"]) == set(JDriftMonitor(None, {}).drift_report())
        assert out["drift"]["n_samples"] >= 1
        if flag == "drift_stale":
            assert not out["drift"]["in_calibration"]
    for key in ("trace_path", "events_path", "metrics_file"):
        if key in kw:
            assert (tmp_path / kw[key]).stat().st_size > 0
    if "metrics_file" in kw:
        assert (tmp_path / "m.prom.json").exists()


SPEC_KW = dict(packed=True, paged=True, kv_bits=8, n_requests=3, rate=0.5)


@pytest.fixture
def one_thread():
    """One intra-op CPU thread: the suite runs files in parallel worker
    processes, and several multi-threaded torch pools on one host stall
    each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flag", [
    dict(spec_k=3), dict(spec_k=3, spec_bits="fit:3.0"),
    dict(spec_k=3, spec_bits="4", spec_kv_bits=4),
    dict(sampling=SamplingParams(temperature=0.7, seed=3)),
    dict(sampling=SamplingParams(temperature=0.7, top_k=5, seed=3)),
    dict(sampling=SamplingParams(temperature=0.7, top_p=0.9, seed=3))])
@pytest.mark.usefixtures("one_thread")
def test_spec_and_sampling_flags_run(flag):
    """The speculative and sampling flags on the smoke config: a
    speculative run emits the plain run's tokens with its ``"spec"``
    entry filled (the FIT proxies for ``fit:AVG``); a sampled run gives
    the same tokens twice, and not the greedy ones."""
    def run(**kw):
        out = tserve.serve("internlm2_1_8b", True, 2, 12, 8, None,
                           device="cpu", **SPEC_KW, **kw)
        assert out["metrics"]["n_finished"] == 3
        return [r.output_tokens.tolist() for r in out["requests"]], out
    plain, _ = run(sampling=flag.get("sampling"))
    got, out = run(**flag)
    if "spec_k" in flag:
        assert got == plain
        sp = out["spec"]
        assert sp["k"] == 3 and sp["dispatches"] > 0
        assert 0 <= sp["accepted"] <= sp["proposed"]
        assert ("fit_accept_proxy" in sp) == ("spec_bits" in flag
                                              and "fit" in flag["spec_bits"])
        if "spec_kv_bits" in flag:
            assert sp["draft_kv_bits"] == 4
    else:
        assert "spec" not in out
        greedy, _ = run()
        assert got == plain and got != greedy


def test_serve_needs_a_gpu_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve("internlm2_1_8b", True, 2, 8, 4, None)
    out = tserve.serve("internlm2_1_8b", True, 2, 8, 4, None, device="cpu")
    assert out["generated"].shape == (2, 4)


def test_main_prints_the_json_dump(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(tserve, "resolve_device", lambda device: torch.device("cpu"))
    path = tmp_path / "m.json"
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "internlm2_1_8b", "--smoke", "--batch", "2",
        "--prompt-len", "12", "--gen-len", "4", "--int8", "--int8-compute",
        "--paged", "--kv-bits", "8", "--requests", "3", "--rate", "0.05",
        "--json", str(path)])
    tserve.main()
    dump = json.loads(capsys.readouterr().out)
    assert dump["metrics"]["n_finished"] == 3
    assert json.loads(path.read_text()) == dump
