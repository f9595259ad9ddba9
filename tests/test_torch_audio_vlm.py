"""The audio family (musicgen_large) in the port against the reference,
on its smoke config: forward logits and loss, ``prefill``, the
``embed`` argument of ``decode_step`` on the paged route, EF weight and
KV-tap traces, allocations given the reference's numbers,
byte-identical QTensors, greedy engine streams (paged and dense) on
(G, CB) token grids, ``sample_tokens`` on (B, CB, V) logits,
``accept_drafts`` over codebooks and ``launch.train``'s losses.
``make_model`` and the model-fixture tests are shared by
``test_torch_vlm.py`` (phi3_vision_4_2b, its image patches first),
which overrides the ``model`` fixture."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import build_report as j_build
from repro.data.synthetic import LMStreamConfig, lm_batches
from repro.kvcache.fit import (allocate_kv_bits as j_kv_bits,
                               kv_report_fns as j_kv_fns)
from repro.launch.train import train as j_train
from repro.models import decode as jdec
from repro.models.transformer import (forward as j_forward,
                                      init_params as j_init, loss_fn as j_loss)
from repro.qtensor import is_qtensor as j_is_qtensor
from repro.quant.policy import QuantPolicy as JPolicy
from repro.serve import sampling as js
from repro.serve.engine import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serve.quantized import (bit_config_from_report as j_bits_from,
                                   quantize_params as j_quantize)
from repro.serve.spec import accept_drafts as j_accept
from repro.utils.pytree import named_leaves as j_named_leaves
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import bit_config_from_reference, params_from_numpy
from repro_torch.core import build_report as t_build
from repro_torch.core.fit import SensitivityReport
from repro_torch.kvcache.fit import (allocate_kv_bits as t_kv_bits,
                                     kv_report_fns as t_kv_fns)
from repro_torch.kvcache.paged import PagedKVConfig
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import uniform_levels
from repro_torch.models import decode as tdec
from repro_torch.models.transformer import forward as t_forward, loss_fn as t_loss
from repro_torch.quant.policy import QuantPolicy as TPolicy
from repro_torch.serve import sampling as ts
from repro_torch.serve.engine import Engine as TEngine, EngineConfig as TEngineConfig
from repro_torch.serve.loadgen import poisson_requests
from repro_torch.serve.quantized import (bit_config_from_report as t_bits_from,
                                         quantize_params as t_quantize)
from repro_torch.serve.spec import SpecConfig, accept_drafts as t_accept
from repro_torch.utils.pytree import named_leaves
from _torch_threads import _one_thread  # noqa: F401

ARCHS = ("musicgen_large", "phi3_vision_4_2b")
ECFG = dict(max_slots=3, max_len=48, max_new_tokens=10, prefill_chunk=8,
            decode_burst=4, page_size=8, int8_compute=True,
            prefix_sharing=False)
AVG_BITS = 6.0
GROUP = 16          # divides every smoke K (48, 64, 96, 128)
SEQ = 24            # the vlm stream: 16 image positions + 8 text tokens


def _stream_cfg(cfg, seq=SEQ, batch=4):
    return LMStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        num_codebooks=cfg.num_codebooks if cfg.family == "audio" else 0,
        img_tokens=cfg.img_tokens if cfg.family == "vlm" else 0,
        d_model=cfg.d_model, seed=0)


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def make_model(arch: str) -> dict:
    """Both packages' params, one report each with the KV taps (one batch
    of 4, microbatch 2), the reference's allocation, KV widths and packed
    trees."""
    jcfg = dataclasses.replace(j_smoke(arch), scan_layers=False)
    tcfg = t_smoke(arch)
    jp = j_init(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    batches = [next(lm_batches(_stream_cfg(jcfg)))]
    jtl, jts, jaf = j_kv_fns(jcfg)
    jr = j_build(lambda p, b: j_loss(p, b, jcfg), jtl, lambda b: jts(jp, b), jaf,
                 jp, [_jnp(b) for b in batches], microbatch=2, tolerance=None,
                 max_batches=1)
    ttl, tts, taf = t_kv_fns(tcfg)
    tr = t_build(lambda p, b: t_loss(p, b, tcfg), ttl, lambda b: tts(tp, b), taf,
                 tp, batches, microbatch=2, tolerance=None, max_batches=1,
                 device="cpu")
    jbits = j_bits_from(jr, JPolicy(allowed_bits=(8, 4)), AVG_BITS)
    tokens = ECFG["max_slots"] * ECFG["max_len"]
    kv_budget = AVG_BITS / 8.0 * 2 * jcfg.num_layers * tokens \
        * jcfg.num_kv_heads * jcfg.head_dim
    kv_bits = j_kv_bits(jr, jcfg, JPolicy(), kv_budget, tokens)
    jq, _ = j_quantize(jp, jbits, JPolicy(allowed_bits=(8, 4)), group_size=GROUP)
    tq, _ = t_quantize(tp, bit_config_from_reference(jbits),
                       TPolicy(allowed_bits=(8, 4)), group_size=GROUP, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jr=jr, tr=tr, jbits=jbits,
                kv_bits=kv_bits, kv_budget=kv_budget, tokens=tokens, jq=jq, tq=tq,
                batch=batches[0])


@pytest.fixture(scope="module")
def model():
    return make_model("musicgen_large")


def test_forward_and_loss_match(model):
    """Logits ((B, S, CB, V) for audio; the image positions first for
    vlm) and the loss within rtol 1e-5 of the reference (fp32 smoke)."""
    jcfg, tcfg, b = model["jcfg"], model["tcfg"], model["batch"]
    jl, _ = jax.jit(lambda p, i: j_forward(p, i, jcfg))(model["jp"], _jnp(b))
    with torch.no_grad():
        tl, _ = t_forward(model["tp"], _torch(b), tcfg)
        tloss = float(t_loss(model["tp"], _torch(b), tcfg))
    assert tl.shape == jl.shape
    if tcfg.family == "audio":
        assert tl.shape[1:3] == (SEQ, tcfg.num_codebooks)
    else:
        assert tl.shape[1] == SEQ == b["tokens"].shape[1] + tcfg.img_tokens
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6)
    jloss = float(j_loss(model["jp"], _jnp(b), jcfg))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)


def test_prefill_matches_forward_and_reference(model):
    """``prefill`` == ``forward`` as the reference's own test holds it
    (max relative difference < 2e-3), within 1e-5 of the reference's
    ``prefill``, its cache too; the vlm image patches are prefilled by
    embedding, their logits first."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    rng = np.random.default_rng(3)
    b, s = 2, 12
    shape = (b, s, tcfg.num_codebooks) if tcfg.family == "audio" else (b, s)
    inputs = {"tokens": rng.integers(0, tcfg.vocab_size, shape).astype(np.int32)}
    if tcfg.family == "vlm":
        inputs["image_embed"] = rng.normal(
            size=(b, tcfg.img_tokens, tcfg.d_model)).astype(np.float32)
    max_len = s + tcfg.img_tokens + 8
    jl, js_ = jdec.prefill(model["jp"], _jnp(inputs), jcfg, max_len)
    with torch.no_grad():
        tl, ts_ = tdec.prefill(model["tp"], _torch(inputs), tcfg, max_len)
        full, _ = t_forward(model["tp"], _torch(inputs), tcfg)
    assert tl.shape == jl.shape == full.shape
    rel = float((full - tl).abs().max() / full.abs().max())
    assert rel < 2e-3, rel
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts_.kv.k.numpy(), np.asarray(js_.kv.k), atol=1e-5)
    assert int(ts_.pos) == int(js_.pos) == full.shape[1]


def test_embed_argument_on_the_paged_route(model):
    """``decode_step(..., embed=...)`` takes the embedding in place of the
    tokens on the paged route as on the dense one: 16-bit pages give the
    dense cache's logits, and the tokens' own embedding gives the token
    step's."""
    tcfg, tp = model["tcfg"], model["tp"]
    b = 2
    rng = np.random.default_rng(5)
    emb = torch.from_numpy(rng.normal(size=(b, 3, tcfg.d_model)).astype(np.float32))
    dense = tdec.init_decode_state(tcfg, b, 16, per_slot_pos=True, device="cpu")
    pc = PagedKVConfig.build(tcfg, 16, b, page_size=8, kv_bits=16)
    paged = tdec.init_paged_decode_state(tcfg, pc, b, device="cpu")
    paged.paged.table.copy_(torch.arange(4, dtype=torch.int32).reshape(b, 2))
    paged.paged.write_limit.fill_(16)
    with torch.no_grad():
        for t in range(3):
            ld, dense = tdec.decode_step(tp, dense, None, tcfg,
                                         embed=emb[:, t:t + 1])
            lp, paged = tdec.decode_step(tp, paged, None, tcfg,
                                         embed=emb[:, t:t + 1])
            torch.testing.assert_close(lp, ld, rtol=0, atol=1e-6)
        shape = (b, 1, tcfg.num_codebooks) if tcfg.family == "audio" else (b, 1)
        tok = torch.ones(shape, dtype=torch.int32)
        by_token, _ = tdec.decode_step(tp, dense, tok, tcfg)
        by_embed, _ = tdec.decode_step(
            tp, paged, None, tcfg,
            embed=tdec.embed_tokens(tp, tok, tcfg))
    torch.testing.assert_close(by_embed, by_token, rtol=0, atol=1e-6)


def test_traces_match(model):
    jr, tr = model["jr"], model["tr"]
    assert list(tr.weight_traces) == list(jr.weight_traces)
    for k, v in jr.weight_traces.items():
        np.testing.assert_allclose(tr.weight_traces[k], v, rtol=1e-4, err_msg=k)
    assert tr.param_sizes == jr.param_sizes
    for k, v in jr.weight_ranges.items():
        np.testing.assert_allclose(tr.weight_ranges[k], v, rtol=0, err_msg=k)
    assert sorted(tr.act_traces) == sorted(jr.act_traces)
    assert len(tr.act_traces) == 2 * model["tcfg"].num_layers     # k and v
    for k, v in jr.act_traces.items():
        np.testing.assert_allclose(tr.act_traces[k], v, rtol=1e-4, err_msg=k)
    for k, v in jr.act_ranges.items():
        np.testing.assert_allclose(tr.act_ranges[k], v, rtol=1e-5, err_msg=k)


def test_allocations_identical_given_reference_numbers(model):
    jr, tcfg = model["jr"], model["tcfg"]
    tr = SensitivityReport.from_json(jr.to_json())
    tb = t_bits_from(tr, TPolicy(allowed_bits=(8, 4)), AVG_BITS)
    jb = model["jbits"]
    assert (tb.weight_bits, tb.act_bits) == (jb.weight_bits, jb.act_bits)
    assert set(tb.weight_bits.values()) == {4, 8}
    assert t_kv_bits(tr, tcfg, TPolicy(), model["kv_budget"], model["tokens"]) \
        == model["kv_bits"]


def test_qtensors_byte_identical(model):
    """Every packed block (the audio family's (D, CB·V) head among them)
    byte for byte; the (CB, V, D) embedding stays fp."""
    jl = dict(j_named_leaves(model["jq"], is_leaf=j_is_qtensor))
    tl = dict(named_leaves(model["tq"]))
    assert list(jl) == list(tl)
    n_packed = 0
    for name, a in jl.items():
        b = tl[name]
        if j_is_qtensor(a):
            n_packed += 1
            assert (b.bits, b.shape, b.axis) == (a.bits, a.shape, a.axis), name
            np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
            np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    tcfg = model["tcfg"]
    mats = 7 if tcfg.act == "swiglu" else 6
    assert n_packed == mats * tcfg.num_layers + 1       # + head
    if tcfg.family == "audio":
        v = model["tp"]["embed"].shape[1]
        assert tl["head"].shape == (tcfg.d_model, tcfg.num_codebooks * v)
        assert tuple(tl["embed"].shape) == (tcfg.num_codebooks, v, tcfg.d_model)


def _requests(cfg):
    return poisson_requests(cfg, 4, rate=0.25, prompt_len=(3, 14),
                            gen_len=(4, 10), seed=1)


@pytest.mark.parametrize("kv_cache", ["paged", "dense"])
def test_engine_streams_match_jax_engine(model, monkeypatch, kv_cache):
    """Greedy streams equal the JAX engine's, token for token: (G, CB)
    grids for audio, text prompts for vlm; paged at the FIT KV widths,
    and on the dense cache."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    ecfg = dict(ECFG, kv_cache=kv_cache)
    kw = (dict(kv_bits=model["kv_bits"], kv_ranges=model["jr"].act_ranges)
          if kv_cache == "paged" else {})
    jeng = JEngine(model["jq"], model["jcfg"], JEngineConfig(**ecfg), **kw)
    jfin, _ = jeng.run(_requests(model["jcfg"]))
    teng = TEngine(model["tq"], model["tcfg"], TEngineConfig(**ecfg),
                   device="cpu", **kw)
    tfin, _ = teng.run(_requests(model["tcfg"]))
    tcfg = model["tcfg"]
    assert [r.id for r in tfin] == [r.id for r in jfin]
    for t, j in zip(tfin, jfin):
        assert t.num_generated == t.max_new_tokens
        cb = (tcfg.num_codebooks,) if tcfg.family == "audio" else ()
        assert t.output_tokens.shape == (t.max_new_tokens,) + cb
        np.testing.assert_array_equal(t.output_tokens, np.asarray(j.output_tokens))


def test_audio_shared_prefix_and_spec_streams():
    """musicgen smoke, port against port: (P, CB) prompts sharing a
    prefix over pages == the dense cache, and speculative streams (k = 3,
    the serving tree as its own draft, an all-codebook accept) == plain,
    greedy and sampled."""
    cfg = t_smoke("musicgen_large")
    from repro_torch.models.transformer import init_params
    p = init_params(cfg, seed=0, device="cpu")
    trace = [(0, 8, 5), (0, 12, 7), (3, 6, 4), (10, 10, 6)]
    from repro_torch.serve.loadgen import trace_requests

    def run(sampling=None, **kw):
        reqs = trace_requests(cfg, trace, sampling=sampling, prefix_len=8)
        fin, m = TEngine(p, cfg, TEngineConfig(**dict(ECFG, **kw)),
                         device="cpu").run(reqs)
        return [r.output_tokens.tolist() for r in fin], m

    dense, _ = run(kv_cache="dense")
    shared, m = run(kv_cache="paged", prefix_sharing=True)
    assert shared == dense and m.kv_shared_tokens > 0
    assert {len(t) for stream in dense for t in stream} == {cfg.num_codebooks}
    sampled = ts.SamplingParams(temperature=0.8, top_k=5, top_p=0.9, seed=7)
    for sp in (None, sampled):
        for kv in ("dense", "paged"):
            plain, _ = run(sampling=sp, kv_cache=kv)
            spec, _ = run(sampling=sp, kv_cache=kv, spec=SpecConfig(k=3))
            assert spec == plain, (sp, kv)


@pytest.mark.parametrize("skip", [False, True])
def test_sample_tokens_on_codebooks_bit_equal(skip):
    """(B, CB, V) logits: each codebook sampled under the row's one key,
    the tokens equal to the reference's, greedy rows the argmax."""
    rng = np.random.default_rng(0)
    b, cb, v = 6, 4, 300
    lg = (rng.normal(size=(b, cb, v)) * 3).astype(np.float32)
    seeds = np.arange(b, dtype=np.int32) * 3 - 4
    tidx = np.arange(b, dtype=np.int32) * 17
    temp = np.array([0.8, 1.0, 0.0, 2.0, 0.7, 0.05], np.float32)
    top_k = np.zeros(b, np.int32) if skip else np.array([50, 0, 1, 0, 10, 3], np.int32)
    top_p = np.ones(b, np.float32) if skip else \
        np.array([0.95, 1.0, 1.0, 0.5, 0.0, 0.9], np.float32)
    want = js.sample_tokens(jnp.asarray(lg), js.request_keys(jnp.asarray(seeds),
                                                             jnp.asarray(tidx)),
                            jnp.asarray(temp), jnp.asarray(top_k),
                            jnp.asarray(top_p), skip_filters=skip)
    got = ts.sample_tokens(torch.from_numpy(lg),
                           ts.request_keys(torch.from_numpy(seeds),
                                           torch.from_numpy(tidx)),
                           torch.from_numpy(temp), torch.from_numpy(top_k),
                           torch.from_numpy(top_p), skip_filters=skip)
    assert got.shape == (b, cb) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[2], lg[2].argmax(-1))
    np.testing.assert_array_equal(ts.greedy_tokens(torch.from_numpy(lg)).numpy(),
                                  np.asarray(js.greedy_tokens(jnp.asarray(lg))))


def test_accept_drafts_on_codebooks():
    """The reference's own audio case: a position matches only if every
    codebook does."""
    drafts = [[[1, 2], [3, 4]], [[1, 2], [3, 9]]]
    targets = [[[1, 2], [3, 4], [5, 6]], [[1, 2], [3, 4], [5, 6]]]
    active = [True, True]
    z = np.zeros(2, np.int32)
    want = j_accept(jnp.asarray(drafts), jnp.asarray(targets),
                    jnp.asarray(active), jnp.asarray(z), jnp.asarray(z + 16))
    got = t_accept(torch.tensor(drafts), torch.tensor(targets),
                   torch.tensor(active), torch.from_numpy(z),
                   torch.from_numpy(z + 16))
    for g, w, expect in zip(got, want, ([3, 2], [2, 1])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), expect)


@pytest.mark.parametrize("arch", ARCHS)
def test_uniform_levels_take_the_dense_blocks(arch):
    lv = uniform_levels(t_smoke(arch), 4, 8, device="cpu")
    assert set(lv.layer_weights) == {"attn/wq", "attn/wk", "attn/wv", "attn/wo",
                                     "mlp/w_up", "mlp/w_down"} | (
        {"mlp/w_gate"} if t_smoke(arch).act == "swiglu" else set())
    assert set(lv.layer_acts) == {"attn/attn_out", "mlp/mlp_h"}


def test_train_losses_match_reference(monkeypatch):
    """Four steps of ``launch.train`` on musicgen smoke from the
    reference's params: the stream's (B, S, CB) grids, the losses within
    1e-5 of ``repro.launch.train``'s."""
    arch = "musicgen_large"
    jcfg = dataclasses.replace(j_smoke(arch), scan_layers=False)
    jp = jax.tree.map(np.asarray, j_init(jcfg, jax.random.key(0)))
    monkeypatch.setattr(ttrain, "init_params", lambda cfg, seed=0, device=None:
                        params_from_numpy(jp, device=device, dtype=cfg.param_dtype))
    kw = dict(smoke=True, steps=4, batch=2, seq=16, ckpt_dir=None, resume=False,
              ckpt_every=0, qat_weight_bits=None, qat_act_bits=None,
              watchdog_s=None)
    want = j_train(arch, **kw)
    got = ttrain.train(arch, **kw, device="cpu")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0, atol=1e-5)
