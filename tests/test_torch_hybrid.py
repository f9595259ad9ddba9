"""The hybrid family (Zamba2: one shared attention/MLP block every
``attn_period`` Mamba2 layers, on the zamba2_7b smoke config) in the port
against the reference: forward and loss (rtol 1e-5) at the smoke depth
and at 5 layers (two groups and a one-layer remainder), SGD lowering the
loss; ``prefill`` == forward (rel < 2e-3) and == the reference's (KV,
SSM and remainder states); ``state_insert_slot``; the FIT report (the
shared block's weights one ``shared/...`` leaf, its taps one
``shared/<g>`` scope an application, traces within 1e-5), allocations,
FIT KV widths and byte-identical QTensors; QAT levels; engine streams:
paged == the JAX engine's, paged == dense, alone == batched, tp=1 and
tp=2 on a CPU mesh == the plain engine; and the reference's refusals
(speculative decoding, a T > 1 step) and its prefix-sharing switch-off."""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.kvcache.fit import allocate_kv_bits as j_kv_bits
from repro.launch.steps import uniform_levels as j_uniform_levels
from repro.models import decode as jdec
from repro.models.transformer import (forward as j_forward, init_params as j_init,
                                      loss_fn as j_loss)
from repro.quant.policy import QuantPolicy as JPolicy
from repro.serve.engine import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serve.quantized import (bit_config_from_report as j_bits_from,
                                   quantize_params as j_quantize)
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import bit_config_from_reference, params_from_numpy
from repro_torch.core.fit import SensitivityReport
from repro_torch.kvcache.fit import allocate_kv_bits as t_kv_bits, kv_sites
from repro_torch.launch.mesh import make_tp_mesh
from repro_torch.launch.steps import uniform_levels as t_uniform_levels
from repro_torch.models import decode as tdec
from repro_torch.models.transformer import (forward as t_forward,
                                            init_params as t_init,
                                            loss_fn as t_loss)
from repro_torch.quant.policy import QuantPolicy as TPolicy
from repro_torch.serve.engine import Engine as TEngine, EngineConfig as TEngineConfig
from repro_torch.serve.loadgen import poisson_requests
from repro_torch.serve.quantized import (bit_config_from_report as t_bits_from,
                                         quantize_params as t_quantize)
from repro_torch.serve.spec import SpecConfig
from repro_torch.utils.pytree import map_with_names, named_leaves
from test_torch_mamba2 import check_qtensors, check_reports, make_reports
from _torch_threads import _one_thread  # noqa: F401

ARCH = "zamba2_7b"
ECFG = dict(max_slots=3, max_len=48, max_new_tokens=12, prefill_chunk=8,
            decode_burst=4, page_size=8, int8_compute=True)
AVG_BITS = 6.0
GROUP = 16          # divides every smoke K (64, 128)


def _pair(cfg_over=None):
    jcfg = dataclasses.replace(j_smoke(ARCH), scan_layers=False, **(cfg_over or {}))
    tcfg = dataclasses.replace(t_smoke(ARCH), **(cfg_over or {}))
    jp = jax.jit(lambda key: j_init(jcfg, key))(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg, jp, tp = _pair()
    jr, tr = make_reports(jcfg, tcfg, jp, tp)
    policy = (8, 4)
    jbits = j_bits_from(jr, JPolicy(allowed_bits=policy), AVG_BITS)
    tokens = ECFG["max_slots"] * ECFG["max_len"]
    n_kv = tcfg.num_layers // tcfg.attn_period
    kv_budget = AVG_BITS / 8.0 * 2 * n_kv * tokens * tcfg.num_kv_heads \
        * tcfg.head_dim
    kv_bits = j_kv_bits(jr, jcfg, JPolicy(), kv_budget, tokens)
    jq, _ = j_quantize(jp, jbits, JPolicy(allowed_bits=policy), group_size=GROUP)
    tq, _ = t_quantize(tp, bit_config_from_reference(jbits),
                       TPolicy(allowed_bits=policy), group_size=GROUP,
                       device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jr=jr, tr=tr, jbits=jbits,
                kv_bits=kv_bits, kv_budget=kv_budget, tokens=tokens, jq=jq,
                tq=tq)


@pytest.fixture(scope="module")
def with_rest():
    """Five layers: two groups of two and a one-layer remainder."""
    return _pair({"num_layers": 5})


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def test_init_layout_matches_reference(model, with_rest):
    for pair in ((model["jp"], model["tp"]), (with_rest[2], with_rest[3])):
        jl = [n for n, _ in named_leaves(jax.tree.map(np.asarray, pair[0]))]
        assert [n for n, _ in named_leaves(pair[1])] == jl
    tp = t_init(with_rest[1], seed=0, device="cpu")
    assert sorted(tp) == ["embed", "final_norm", "groups", "head", "rest", "shared"]
    assert sorted(tp["groups"]) == ["0", "1"] and sorted(tp["rest"]) == ["0"]
    assert [(n, tuple(v.shape), v.dtype) for n, v in named_leaves(tp)] == \
        [(n, tuple(v.shape), v.dtype) for n, v in named_leaves(with_rest[3])]


@pytest.mark.parametrize("depth", ["smoke", "with_rest"])
def test_forward_and_loss_match(model, with_rest, depth):
    jcfg, tcfg, jp, tp = ((model["jcfg"], model["tcfg"], model["jp"], model["tp"])
                          if depth == "smoke" else with_rest)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 40)
                                             ).astype(np.int32)
    jin = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tin = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    jl, jloss = jax.jit(lambda p, i: (j_forward(p, i, jcfg)[0],
                                      j_loss(p, i, jcfg)))(jp, jin)
    with torch.no_grad():
        tl, _ = t_forward(tp, tin, tcfg)
        tloss = t_loss(tp, tin, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_loss_decreases_under_sgd(model):
    cfg = model["tcfg"]
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    leaves = {n: v.clone().requires_grad_(True)
              for n, v in named_leaves(model["tp"])}
    tree = map_with_names(lambda n, _: leaves[n], model["tp"])
    losses = []
    for _ in range(8):
        loss = t_loss(tree, batch, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for v, g in zip(leaves.values(), grads):
                v -= 0.05 * g
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0], losses


def test_prefill_matches_forward_and_reference(with_rest):
    jcfg, tcfg, jp, tp = with_rest
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 32)
                                             ).astype(np.int32)
    with torch.no_grad():
        full, _ = t_forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
        dec, st = tdec.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg, 40)
    rel = (full - dec).abs().max().item() / full.abs().max().item()
    assert rel < 2e-3, rel
    jl, js_ = jax.jit(lambda p, t: jdec.prefill(p, {"tokens": t}, jcfg, 40))(
        jp, jnp.asarray(toks))
    np.testing.assert_allclose(dec.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    for got, want in ((st.kv.k, js_.kv.k), (st.kv.v, js_.kv.v),
                      (st.ssm.h, js_.ssm.h), (st.ssm.conv, js_.ssm.conv),
                      (st.rest.h, js_.rest.h), (st.rest.conv, js_.rest.conv)):
        assert tuple(got.shape) == np.asarray(want).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert int(st.pos) == int(js_.pos) == 32
    with pytest.raises(ValueError, match="rollback-able"):
        tdec.decode_step(tp, st, torch.zeros((2, 2), dtype=torch.int32), tcfg)


def test_state_insert_slot(with_rest):
    """A batch-1 prefilled state lands in slot 1 whole — the shared
    block's KV rows, the groups' SSM states (batch axis 2) and the
    remainder's (axis 1) — the other slots untouched."""
    _, cfg, _, tp = with_rest
    big = tdec.init_decode_state(cfg, 3, 16, per_slot_pos=True, device="cpu")
    for t in (big.ssm.h, big.ssm.conv, big.rest.h, big.rest.conv):
        t.fill_(5.0)
    sub = tdec.init_decode_state(cfg, 1, 16, device="cpu")
    with torch.no_grad():
        _, sub = tdec.prefill_into(tp, sub, torch.zeros((1, 5), dtype=torch.int32),
                                   cfg)
    merged = tdec.state_insert_slot(cfg, big, sub, 1)
    assert merged.pos.tolist() == [0, 5, 0]
    assert torch.equal(merged.kv.k[:, 1], sub.kv.k[:, 0])
    assert not merged.kv.k[:, 0].any()
    assert torch.equal(merged.ssm.h[:, :, 1], sub.ssm.h[:, :, 0])
    assert torch.equal(merged.ssm.conv[:, :, 1], sub.ssm.conv[:, :, 0])
    assert torch.equal(merged.rest.h[:, 1], sub.rest.h[:, 0])
    assert torch.equal(merged.rest.conv[:, 1], sub.rest.conv[:, 0])
    for t in (merged.ssm.h[:, :, 0], merged.ssm.conv[:, :, 2],
              merged.rest.h[:, 2], merged.rest.conv[:, 0]):
        assert (t == 5.0).all()


# --------------------------------------------------------------------------
# FIT
# --------------------------------------------------------------------------

def test_report_matches(model):
    jr, tr = model["jr"], model["tr"]
    check_reports(jr, tr)
    # the shared block: one weight leaf, one tap scope an application
    assert "shared/attn/wq" in tr.weight_traces
    assert not any(k.startswith("shared/0/") for k in tr.weight_traces)
    for g in range(model["tcfg"].num_layers // model["tcfg"].attn_period):
        assert f"shared/{g}/attn/k" in tr.act_traces
        assert f"groups/{g}/1/mixer/ssd_out" in tr.act_traces
    assert [s for pair in kv_sites(model["tcfg"]) for s in pair] == \
        ["shared/0/attn/k", "shared/0/attn/v", "shared/1/attn/k",
         "shared/1/attn/v"]


def test_allocations_kv_widths_and_qtensors_identical(model):
    jr, tcfg = model["jr"], model["tcfg"]
    tr = SensitivityReport.from_json(jr.to_json())
    tb = t_bits_from(tr, TPolicy(allowed_bits=(8, 4)), AVG_BITS)
    jb = model["jbits"]
    assert (tb.weight_bits, tb.act_bits) == (jb.weight_bits, jb.act_bits)
    assert t_kv_bits(tr, tcfg, TPolicy(), model["kv_budget"], model["tokens"]) \
        == model["kv_bits"]
    n_packed = check_qtensors(model["jq"], model["tq"])
    # 6 matmuls a Mamba2 layer, 7 in the shared block (stored once), the head
    assert n_packed == 6 * tcfg.num_layers + 7 + 1


def test_uniform_levels_are_empty_as_in_reference(model):
    t, j = t_uniform_levels(model["tcfg"], 3, 3, device="cpu"), \
        j_uniform_levels(model["jcfg"], 3, 3)
    assert (t.layer_weights, t.layer_acts) == ({}, {})
    assert (dict(j.layer_weights), dict(j.layer_acts)) == ({}, {})
    toks = torch.zeros((2, 16), dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        assert float(t_loss(model["tp"], batch, model["tcfg"], qat=t)) == \
            float(t_loss(model["tp"], batch, model["tcfg"]))


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _requests(cfg, n=5):
    # one prompt length keeps the JAX engine to one prefill shape
    return poisson_requests(cfg, n, rate=0.25, prompt_len=8, gen_len=(4, 12),
                            seed=1)


def _streams(fin):
    return [np.asarray(r.output_tokens).tolist() for r in fin]


def _kw(model, kv_cache):
    return (dict(kv_bits=model["kv_bits"], kv_ranges=model["jr"].act_ranges)
            if kv_cache == "paged" else {})


@pytest.fixture(scope="module")
def plain(model):
    """The port's plain engine and its streams: paged at the FIT KV
    widths, and at 16-bit pages beside the dense cache."""
    out = {}
    for tag, kv, kw in (("paged", "paged", _kw(model, "paged")),
                        ("paged16", "paged", {}), ("dense", "dense", {})):
        eng = TEngine(model["tq"], model["tcfg"],
                      TEngineConfig(**dict(ECFG, kv_cache=kv)), device="cpu",
                      **kw)
        fin, _ = eng.run(_requests(model["tcfg"]))
        out[tag] = (eng, _streams(fin))
    return out


def test_paged_streams_match_jax_engine(model, plain, monkeypatch):
    """The FIT KV widths' paged pools; the JAX engine at one-step bursts
    (one compiled burst shape: a row's tokens do not depend on the burst
    grain)."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    from repro.serve.loadgen import poisson_requests as j_poisson
    jeng = JEngine(model["jq"], model["jcfg"],
                   JEngineConfig(**dict(ECFG, kv_cache="paged", decode_burst=1)),
                   **_kw(model, "paged"))
    jfin, _ = jeng.run(j_poisson(model["jcfg"], 5, rate=0.25, prompt_len=8,
                                 gen_len=(4, 12), seed=1))
    assert plain["paged"][1] == _streams(jfin)


def test_paged_equals_dense_and_alone_equals_batched(model, plain):
    """16-bit pages hold the dense cache's values: the same streams (the
    FIT widths quantize the KV, so those streams may differ)."""
    assert plain["paged16"][1] == plain["dense"][1]
    eng, streams = plain["paged"]
    for i in (0, 3):
        alone = [r for r in _requests(model["tcfg"]) if r.id == i]
        alone[0].arrival_time = 0.0
        got, _ = eng.run(alone)
        assert _streams(got) == [streams[i]]


@pytest.mark.parametrize("tp", [1, 2])
def test_tp_streams_equal_plain_engine(model, plain, tp):
    """The shared block's projections column/row-sharded, the Mamba2
    projections too (out_proj row-parallel), pools kv-sharded at tp=2,
    the SSM states on the lead device: the plain engine's streams."""
    eng = TEngine(model["tq"], model["tcfg"],
                  TEngineConfig(**dict(ECFG, kv_cache="paged",
                                       mesh=make_tp_mesh(tp, "cpu"))),
                  **_kw(model, "paged"))
    fin, _ = eng.run(_requests(model["tcfg"]))
    assert _streams(fin) == plain["paged"][1]
    assert eng._kv_shards == tp
    if tp == 2:
        plan = eng._shard_plan
        assert plan["groups/0/0/mixer/out_proj"] == "row"
        assert plan["groups/1/1/mixer/wdt"] == "col"
        assert plan["shared/mlp/w_down"] == "row"


def test_refusals_and_prefix_sharing_match_reference(model, caplog, monkeypatch):
    """Speculative decoding is refused by both engines; paged serving
    turns prefix sharing off with the reference's log line; a T > 1
    paged step is refused."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    from repro.serve import SpecConfig as JSpecConfig
    with pytest.raises(ValueError, match="rollback-able"):
        JEngine(model["jq"], model["jcfg"],
                JEngineConfig(**dict(ECFG, spec=JSpecConfig(k=4))))
    with pytest.raises(ValueError, match="rollback-able"):
        TEngine(model["tq"], model["tcfg"],
                TEngineConfig(**dict(ECFG, spec=SpecConfig(k=4))), device="cpu")
    msg = "hybrid family: prefix sharing disabled"
    with caplog.at_level(logging.INFO):
        eng = TEngine(model["tq"], model["tcfg"],
                      TEngineConfig(**dict(ECFG, kv_cache="paged",
                                           prefix_sharing=True)),
                      device="cpu", **_kw(model, "paged"))
        jeng = JEngine(model["jq"], model["jcfg"],
                       JEngineConfig(**dict(ECFG, kv_cache="paged",
                                            prefix_sharing=True)),
                       **_kw(model, "paged"))
    # the reference logs the same line through its own handler
    logged = [r.getMessage() for r in caplog.records
              if r.name == "repro_torch.serve.engine" and msg in r.getMessage()]
    assert logged == [msg + " (SSM state at the split is not cached)"]
    assert eng._share is False and jeng._share is False
    # a shared prefix is served without sharing, as with it off
    from repro_torch.serve.loadgen import trace_requests
    trace = [(0, 20, 6), (0, 20, 6)]
    fin, m = eng.run(trace_requests(model["tcfg"], trace, prefix_len=16))
    assert m.summary()["kv_shared_tokens"] == 0
    off = TEngine(model["tq"], model["tcfg"],
                  TEngineConfig(**dict(ECFG, kv_cache="paged",
                                       prefix_sharing=False)),
                  device="cpu", **_kw(model, "paged"))
    fin_off, _ = off.run(trace_requests(model["tcfg"], trace, prefix_len=16))
    assert _streams(fin) == _streams(fin_off)
    st = eng._state
    with pytest.raises(ValueError, match="rollback-able"):
        tdec.decode_step(model["tq"], st, torch.zeros((3, 2), dtype=torch.int32),
                         model["tcfg"])
