"""Self-speculative decoding in the port (``repro_torch.serve.spec`` and
the engine's draft/verify dispatch) on the smoke configs.

The contract the verify pass rests on comes first: a T-token
``decode_step`` is bitwise T one-token steps, logits and cache, on every
route the engine serves (fp params, packed with fp dequant, packed with
``int8_compute``, int8-backed, MoE grouped/dense at non-binding
capacity; dense, int8 dense and paged caches). Then the module against
the reference (accept arithmetic, the dense int8 KV grid, narrowed
draft trees byte for byte, ``allocate_draft_bits``) and the engine's
own contract, port against port: speculative streams equal plain
streams, greedy and sampled."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core.fit import SensitivityReport as JReport, allocate_draft_bits as j_alloc
from repro.models import decode as jdec
from repro.models.transformer import init_params as j_init
from repro.qtensor import is_qtensor as j_is_qtensor
from repro.serve.quantized import quantize_params as j_quantize
from repro.serve.spec import (accept_drafts as j_accept,
                              derive_draft_params as j_derive)
from repro.utils.pytree import named_leaves as j_named_leaves
from repro_torch.configs import smoke_config
from repro_torch.convert import (bit_config_from_reference,
                                 draft_plan_from_reference, params_from_numpy)
from repro_torch.core.fit import SensitivityReport, allocate_draft_bits
from repro_torch.kvcache.paged import PagedKVConfig
from repro_torch.models import decode as tdec
from repro_torch.models.context import Context, DequantContext
from repro_torch.models.transformer import init_params
from repro_torch.qtensor import QTensor
from repro_torch.serve import (Engine, EngineConfig, SamplingParams, SpecConfig,
                               derive_draft_params, quantize_params,
                               quantize_params_int8, trace_requests)
from repro_torch.serve.quantized import make_dequant_context
from repro_torch.serve.spec import accept_drafts, quantize_dense_kv
from repro_torch.utils.pytree import named_leaves
from _torch_threads import _one_thread  # noqa: F401

ARCH = "internlm2_1_8b"
# staggered arrivals and more requests than slots: dispatches run across
# admissions, evictions and backfills
TRACE = [(0, 8, 5), (0, 12, 7), (3, 6, 4), (10, 10, 6), (11, 5, 8)]
ECFG = dict(max_slots=2, max_len=64, max_new_tokens=16, prefill_chunk=4,
            decode_burst=4)
SAMPLED = SamplingParams(temperature=0.8, top_k=5, top_p=0.9, seed=7)


@pytest.fixture(scope="module")
def dense():
    cfg = smoke_config(ARCH)
    p = init_params(cfg, seed=0, device="cpu")
    qp, _ = quantize_params(p, 8, group_size=8, device="cpu")
    return cfg, p, qp


@pytest.fixture(scope="module")
def moe():
    # capacity non-binding: the reference's own MoE condition for spec
    cfg = dataclasses.replace(smoke_config("olmoe_1b_7b"), capacity_factor=8.0)
    p = init_params(cfg, seed=0, device="cpu")
    qp, _ = quantize_params(p, 8, group_size=8, device="cpu")
    return cfg, qp


# --------------------------------------------------------------------------
# multi-token decode == sequential decode, bit for bit
# --------------------------------------------------------------------------

def _mt_check(cfg, params, ctx, kv, T=4, B=3):
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, 6), generator=g,
                           dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=g,
                         dtype=torch.int32)

    def prefilled():
        if kv == "paged":
            pc = PagedKVConfig.build(cfg, 64, B, page_size=8, kv_bits={0: 8, 1: 4})
            st = tdec.init_paged_decode_state(cfg, pc, B, device="cpu")
            st.paged.table.copy_(torch.arange(B * pc.pages_per_slot,
                                              dtype=torch.int32).reshape(B, -1))
            st.paged.write_limit.fill_(64)
        else:
            st = tdec.init_decode_state(
                cfg, B, 64, per_slot_pos=True, device="cpu",
                kv_dtype=torch.int8 if kv == "dense_int8" else None)
        return tdec.prefill_into(params, st, prompt, cfg, ctx=ctx)[1]

    with torch.no_grad():
        sa, seq = prefilled(), []           # caches update in place: two
        for j in range(T):
            lg, sa = tdec.decode_step(params, sa, toks[:, j:j + 1], cfg, ctx=ctx)
            seq.append(lg[:, 0])
        fused, sb = tdec.decode_step(params, prefilled(), toks, cfg, ctx=ctx)
    assert torch.equal(torch.stack(seq, 1), fused)
    if kv == "paged":
        for name, la in sa.paged.layers.items():
            lb = sb.paged.layers[name]
            assert torch.equal(la.k, lb.k) and torch.equal(la.v, lb.v)
    else:
        assert torch.equal(sa.kv.k, sb.kv.k) and torch.equal(sa.kv.v, sb.kv.v)
    assert torch.equal(sa.pos, sb.pos)


ROUTES = ["fp", "packed_fp_dequant", "packed_int8_compute",
          "int8_backed"]


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("route", ROUTES)
def test_multi_token_decode_equals_sequential(dense, route, kv):
    """The engine's default route (packed, fp dequant) gave the fused
    call's rows other bits than one-token steps before the decode step
    ran row-count-dependent ops one column at a time."""
    cfg, p, qp = dense
    if route == "fp":
        params, ctx = p, Context()
    elif route == "int8_backed":
        params, scales = quantize_params_int8(p, 8, device="cpu")
        ctx = make_dequant_context(cfg, scales, int8_compute=True)
    else:
        params = qp
        ctx = DequantContext(None, cfg.param_dtype,
                             int8_compute=route == "packed_int8_compute")
    _mt_check(cfg, params, ctx, kv)


@pytest.mark.parametrize("dispatch", ["grouped", "dense"])
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_multi_token_decode_moe(moe, dispatch, kv):
    cfg, qp = moe
    _mt_check(cfg, qp, DequantContext(None, cfg.param_dtype, int8_compute=True,
                                      moe_dispatch=dispatch), kv)


def test_multi_token_decode_dense_int8_lane(dense):
    cfg, p, _ = dense
    _mt_check(cfg, p, Context(), "dense_int8")


def test_dense_int8_lane_matches_reference():
    """The draft lane's int8 dense cache (the reference's
    ``attention_decode`` at int8: the static 0.05 grid) against the
    reference: per-step logits within 1e-5, the cache's bytes equal."""
    jcfg = dataclasses.replace(j_smoke(ARCH), scan_layers=False)
    jp = jax.jit(lambda key: j_init(jcfg, key))(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cfg, b = smoke_config(ARCH), 2
    js = jdec.init_decode_state(jcfg, b, 32, per_slot_pos=True)
    js = js._replace(kv=jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.int8),
                                     js.kv))
    ts = tdec.init_decode_state(cfg, b, 32, per_slot_pos=True, device="cpu",
                                kv_dtype=torch.int8)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, 7),
                                             dtype=np.int32)
    step = jax.jit(lambda p, s, t: jdec.decode_step(p, s, t, jcfg))
    with torch.no_grad():
        for i in range(toks.shape[1]):
            jl, js = step(jp, js, jnp.asarray(toks[:, i:i + 1]))
            tl, ts = tdec.decode_step(tp, ts, torch.from_numpy(toks[:, i:i + 1]),
                                      cfg)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                       rtol=0)
    np.testing.assert_array_equal(ts.kv.k.numpy(), np.asarray(js.kv.k))
    np.testing.assert_array_equal(ts.kv.v.numpy(), np.asarray(js.kv.v))


# --------------------------------------------------------------------------
# the module against the reference
# --------------------------------------------------------------------------

def test_accept_drafts_arithmetic():
    drafts = [[5, 6, 7], [5, 9, 7], [1, 2, 3], [5, 6, 7]]
    targets = [[5, 6, 7, 8], [5, 6, 7, 8], [9, 2, 3, 4], [5, 6, 7, 8]]
    active = [True, True, True, False]
    budget = [16] * 4
    for nwritten, emit in (([0] * 4, [4, 2, 1, 0]), ([14] * 4, [2, 2, 1, 0])):
        args = (drafts, targets, active, nwritten, budget)
        n_emit, n_match = accept_drafts(*(torch.tensor(a) for a in args))
        j_emit, j_match = j_accept(*(jnp.asarray(a) for a in args))
        assert n_emit.tolist() == emit == np.asarray(j_emit).tolist()
        assert n_match.tolist() == [3, 1, 0, 3] == np.asarray(j_match).tolist()


def test_quantize_dense_kv_grid():
    kv = torch.tensor([[0.1, -0.2, 10.0, 0.025, -0.075]])
    q = quantize_dense_kv(kv, 8)
    # the static 0.05 grid, half to even, saturating at +-127
    assert q.dtype == torch.int8
    assert q.tolist() == [[2, -4, 127, 0, -2]]
    assert quantize_dense_kv(kv, 16) is kv
    with pytest.raises(ValueError, match="dense draft KV"):
        quantize_dense_kv(kv, 4)


def _reports(seed=0):
    """One random sensitivity report of the smoke config's blocks, as the
    reference's and as the port's."""
    cfg = smoke_config(ARCH)
    p = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(seed)
    names = [n for n, leaf in named_leaves(p) if leaf.ndim == 2]
    d = dict(weight_traces={n: float(rng.uniform(1e-3, 10.0)) for n in names},
             act_traces={}, act_ranges={},
             weight_ranges={n: (float(-rng.uniform(0.1, 1)),
                                float(rng.uniform(0.1, 1))) for n in names},
             param_sizes={n: int(dict(named_leaves(p))[n].numel())
                          for n in names})
    return JReport(**d), SensitivityReport(**d)


@pytest.mark.parametrize("avg_bits", [3.0, 4.5, 6.0])
def test_allocate_draft_bits_matches_reference(avg_bits):
    jr, tr = _reports()
    want, got = j_alloc(jr, avg_bits=avg_bits), allocate_draft_bits(tr, avg_bits=avg_bits)
    assert got.bits.weight_bits == dict(want.bits.weight_bits)
    assert got.bits.act_bits == {}
    for f in ("kl_proxy", "accept_proxy", "avg_bits"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=1e-6)
    assert got.bits == draft_plan_from_reference(want).bits
    assert 0.0 < got.accept_proxy <= 1.0


def test_derive_draft_params_byte_identical_to_reference():
    """A W8 tree narrowed by the reference's FIT plan, on both sides: the
    same blocks re-packed at the same widths with the same bytes; blocks
    at or below their draft width shared by reference."""
    jcfg = dataclasses.replace(j_smoke(ARCH), scan_layers=False)
    jp = jax.jit(lambda key: j_init(jcfg, key))(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jq, _ = j_quantize(jp, 8, group_size=8)
    tq, _ = quantize_params(tp, 8, group_size=8, device="cpu")
    jr, _ = _reports()
    plan = j_alloc(jr, avg_bits=4.0)
    jd = dict(j_named_leaves(j_derive(jq, plan.bits), is_leaf=j_is_qtensor))
    td = derive_draft_params(tq, bit_config_from_reference(plan.bits))
    src = dict(named_leaves(tq))
    narrowed = 0
    for name, leaf in named_leaves(td):
        want = jd[name]
        if isinstance(leaf, QTensor):
            assert (leaf.bits, leaf.shape, leaf.axis) == (want.bits, want.shape,
                                                           want.axis), name
            np.testing.assert_array_equal(leaf.data.numpy(), np.asarray(want.data))
            np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(want.scale))
            narrowed += leaf.bits < 8
            if leaf.bits == 8:
                assert leaf is src[name]
        else:
            assert leaf is src[name]
    assert narrowed > 0
    for _, leaf in named_leaves(derive_draft_params(tq, 16)):
        assert not isinstance(leaf, QTensor) or leaf.bits == 8


def test_spec_config_validation(dense):
    cfg, p, qp = dense
    with pytest.raises(TypeError, match="SpecConfig"):
        Engine(p, cfg, EngineConfig(**ECFG, spec=object()), device="cpu")
    with pytest.raises(ValueError, match="QTensor"):
        Engine(p, cfg, EngineConfig(**ECFG, spec=SpecConfig(k=2, draft_bits=4)),
               device="cpu")
    with pytest.raises(ValueError, match="draft KV lane"):
        Engine(p, cfg, EngineConfig(**ECFG, spec=SpecConfig(k=2, draft_kv_bits=4)),
               device="cpu")
    from repro_torch.launch.mesh import make_tp_mesh
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        Engine(qp, cfg, EngineConfig(**ECFG, int8_compute=True,
                                     mesh=make_tp_mesh(2, "cpu"),
                                     spec=SpecConfig(k=2)))


# --------------------------------------------------------------------------
# speculative streams == plain streams
# --------------------------------------------------------------------------

def _parity(params, cfg, spec, sampling=None, prefix_len=0, **extra):
    def reqs():
        return trace_requests(cfg, TRACE, sampling=sampling,
                              prefix_len=prefix_len)
    ecfg = dict(ECFG, **extra)
    base, _ = Engine(params, cfg, EngineConfig(**ecfg), device="cpu").run(reqs())
    eng = Engine(params, cfg, EngineConfig(**ecfg, spec=spec), device="cpu")
    fin, m = eng.run(reqs())
    assert [r.output_tokens.tolist() for r in fin] == \
        [r.output_tokens.tolist() for r in base]
    return eng, m


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_spec_equals_plain(dense, kv_cache, sampled):
    """The serving tree as its own draft over an int8 KV lane (dense:
    the static-scale cache; paged: 8-bit pools)."""
    cfg, p, _ = dense
    extra = dict(kv_cache="paged", page_size=8) if kv_cache == "paged" else {}
    _parity(p, cfg, SpecConfig(k=3), sampling=SAMPLED if sampled else None,
            **extra)


@pytest.mark.parametrize("sampled", [False, True])
def test_spec_narrowed_draft_equals_plain(dense, sampled):
    """W8 serving on the integer kernels, the draft narrowed to W4 and
    materialized to fp; and the draft kept packed on the integer
    kernels."""
    cfg, _, qp = dense
    sp = SAMPLED if sampled else None
    _parity(qp, cfg, SpecConfig(k=4, draft_bits=4), sampling=sp,
            int8_compute=True)
    _parity(qp, cfg, SpecConfig(k=4, draft_bits=4, draft_kv_bits=16,
                                int8_compute=True, materialize_draft=False),
            sampling=sp)


def test_spec_shared_prefix_4bit_draft_kv(dense):
    """Paged serving with prefix sharing; the draft pools store packed
    int4 KV and mirror the copy-on-write copies."""
    cfg, _, qp = dense
    eng, m = _parity(qp, cfg, SpecConfig(k=3, draft_bits=4, draft_kv_bits=4),
                     prefix_len=9, int8_compute=True, kv_cache="paged",
                     page_size=8)
    s = m.summary()
    assert s["kv_shared_tokens"] > 0 and s["kv_cow_copies"] > 0
    assert eng._dpcfg.kv_bits == (4, 4)


def test_spec_moe_equals_plain(moe):
    cfg, qp = moe
    for dispatch in ("grouped", "dense"):
        _parity(qp, cfg, SpecConfig(k=3, draft_bits=4), int8_compute=True,
                moe_dispatch=dispatch, kv_cache="paged", page_size=8)


def test_spec_k1_degenerates_to_plain_burst(dense):
    cfg, p, _ = dense
    eng, _ = _parity(p, cfg, SpecConfig(k=1))
    assert eng._spec is None and eng._draft_params is None
    assert eng.spec_stats == {"proposed": 0, "accepted": 0, "dispatches": 0}


def test_spec_stats_tallies(dense):
    """Dispatches, proposals (k per active slot a dispatch) and accepted
    drafts (emitted minus the correction-or-bonus token) add up with the
    engine's metrics: every token after the first of a request was
    emitted by a dispatch, at most k + 1 a slot."""
    cfg, p, _ = dense
    k = 3
    eng, m = _parity(p, cfg, SpecConfig(k=k))
    st = eng.spec_stats
    fin, _ = eng.run(trace_requests(cfg, TRACE))
    assert st == eng.spec_stats                 # a run starts from zero
    assert st["dispatches"] > 0
    assert m.decode_steps == (k + 1) * st["dispatches"]
    slot_dispatches = st["proposed"] // k
    assert st["proposed"] == k * slot_dispatches
    assert st["dispatches"] <= slot_dispatches <= ECFG["max_slots"] * st["dispatches"]
    assert m.decode_tokens == sum(r.num_generated - 1 for r in fin)
    assert 0 < st["accepted"] <= m.decode_tokens <= st["accepted"] + slot_dispatches
