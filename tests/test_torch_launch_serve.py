"""The port's serving CLI (``repro_torch.launch.serve``) against
``repro.launch.serve`` on the CPU at smoke size: PTQ pinning, closed-loop
``generated`` equal to the reference's on the int8-backed paged route
with a shared prefix, the speculative and sampling flags at smoke size,
the refusal of flags not ported yet, the GPU default, and ``main()``'s
JSON dump."""
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


@pytest.mark.parametrize("flag", [
    dict(trace_path="t.json"), dict(events_path="e.jsonl"),
    dict(metrics_file="m.prom"), dict(metrics_port=0), dict(drain_every=4),
    dict(drift_every=1), dict(drift_stale=2.0), dict(drift_threshold=2.0)])
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        tserve.serve("internlm2_1_8b", True, 2, 8, 4, None, device="cpu", **flag)


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
