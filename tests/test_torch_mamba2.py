"""The ssm family (Mamba2, the mamba2_130m smoke config) in the port
against the reference: the chunked SSD scan (S not a multiple of the
chunk), the depthwise causal conv and the one-token recurrence, each at
fp32 within 1e-5; forward and loss (rtol 1e-5), SGD lowering the loss,
``grad_barrier`` on a bf16 variant; ``prefill`` == forward (rel < 2e-3)
and == the reference's; ``state_insert_slot``; the FIT report (the same
keys, the ``mixer/conv_out`` and ``mixer/ssd_out`` taps among them,
traces within 1e-5); allocations and byte-identical QTensors; QAT
levels; greedy and sampled engine streams == the JAX engine's, alone ==
batched; and the reference's refusals (paged KV, speculative decoding,
a T > 1 decode step)."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import build_report as j_build
from repro.core.mpq import greedy_allocate as j_greedy
from repro.data.synthetic import LMStreamConfig, lm_batches
from repro.launch.steps import uniform_levels as j_uniform_levels
from repro.models import decode as jdec
from repro.models import mamba2 as jm
from repro.models.context import (CollectContext as JCollect,
                                  TapContext as JTapContext)
from repro.models.layers import grad_barrier as j_grad_barrier
from repro.models.transformer import (forward as j_forward, init_params as j_init,
                                      loss_fn as j_loss)
from repro.qtensor import is_qtensor as j_is_qtensor
from repro.quant.policy import QuantPolicy as JPolicy
from repro.serve.engine import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serve.quantized import (bit_config_from_report as j_bits_from,
                                   quantize_params as j_quantize)
from repro.utils.pytree import named_leaves as j_named_leaves
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import bit_config_from_reference, params_from_numpy
from repro_torch.core import build_report as t_build
from repro_torch.core.fit import SensitivityReport
from repro_torch.core.mpq import greedy_allocate as t_greedy
from repro_torch.launch.steps import uniform_levels as t_uniform_levels
from repro_torch.models import decode as tdec
from repro_torch.models import mamba2 as tm
from repro_torch.models.context import CollectContext, TapContext
from repro_torch.models.layers import _GradBarrier, grad_barrier
from repro_torch.models.transformer import forward as t_forward, loss_fn as t_loss
from repro_torch.quant.policy import QuantPolicy as TPolicy
from repro_torch.serve import sampling as ts
from repro_torch.serve.engine import Engine as TEngine, EngineConfig as TEngineConfig
from repro_torch.serve.loadgen import poisson_requests
from repro_torch.serve.quantized import (bit_config_from_report as t_bits_from,
                                         quantize_params as t_quantize)
from repro_torch.serve.spec import SpecConfig
from repro_torch.utils.pytree import named_leaves
from _torch_threads import _one_thread  # noqa: F401

ARCH = "mamba2_130m"
ECFG = dict(max_slots=3, max_len=48, max_new_tokens=12, prefill_chunk=8,
            decode_burst=4, int8_compute=True)
AVG_BITS = 6.0
GROUP = 16          # divides every smoke K (64, 128)
SAMPLING = ts.SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=11)


def _np(t):
    return np.asarray(t)


def all_tap_fns(cfg, loss, collect, tap_ctx):
    """(tap_loss_fn, act_fn) over every activation site of the model, for
    either package's ``build_report``."""
    def act_fn(params, batch):
        ctx = collect()
        loss(params, batch, cfg, ctx=ctx)
        return dict(ctx.acts)

    def tap_loss_fn(params, taps, batch):
        return loss(params, batch, cfg, ctx=tap_ctx(taps))

    return tap_loss_fn, act_fn


def make_reports(jcfg, tcfg, jp, tp):
    """One report each over every activation site: one batch of 4 x 16,
    microbatch 2 (the JAX side's activations jitted, its tap shapes
    traced abstractly)."""
    stream = lm_batches(LMStreamConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                       global_batch=4, seed=0))
    batches = [next(stream)]
    jtl, jaf = all_tap_fns(jcfg, j_loss, JCollect, JTapContext)
    jr = j_build(lambda p, b: j_loss(p, b, jcfg), jtl,
                 lambda b: jax.eval_shape(jaf, jp, b), jax.jit(jaf), jp,
                 [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
                 microbatch=2, tolerance=None, max_batches=1)
    ttl, taf = all_tap_fns(tcfg, t_loss, CollectContext, TapContext)
    tr = t_build(lambda p, b: t_loss(p, b, tcfg), ttl,
                 lambda b: {k: (tuple(a.shape), a.dtype)
                            for k, a in taf(tp, b).items()},
                 taf, tp, batches, microbatch=2, tolerance=None,
                 max_batches=1, device="cpu")
    return jr, tr


def check_reports(jr, tr):
    assert list(tr.weight_traces) == list(jr.weight_traces)
    for k, v in jr.weight_traces.items():
        np.testing.assert_allclose(tr.weight_traces[k], v, rtol=1e-5, err_msg=k)
    assert tr.param_sizes == jr.param_sizes
    for k, v in jr.weight_ranges.items():
        np.testing.assert_allclose(tr.weight_ranges[k], v, rtol=0, err_msg=k)
    assert sorted(tr.act_traces) == sorted(jr.act_traces)
    for k, v in jr.act_traces.items():
        np.testing.assert_allclose(tr.act_traces[k], v, rtol=1e-5, err_msg=k)
    for k, v in jr.act_ranges.items():
        np.testing.assert_allclose(tr.act_ranges[k], v, rtol=1e-5, err_msg=k)


def check_qtensors(jq, tq) -> int:
    """Payloads and scales byte for byte; returns the packed count."""
    jl = dict(j_named_leaves(jq, is_leaf=j_is_qtensor))
    tl = dict(named_leaves(tq))
    assert list(jl) == list(tl)
    n_packed = 0
    for name, a in jl.items():
        b = tl[name]
        if j_is_qtensor(a):
            n_packed += 1
            assert (b.bits, b.shape, b.axis) == (a.bits, a.shape, a.axis), name
            np.testing.assert_array_equal(b.data.numpy(), _np(a.data))
            np.testing.assert_array_equal(b.scale.numpy(), _np(a.scale))
        else:
            assert str(b.dtype) == f"torch.{_np(a).dtype.name}", name
            np.testing.assert_array_equal(b.float().numpy(),
                                          _np(a).astype(np.float32))
    return n_packed


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(j_smoke(ARCH), scan_layers=False)
    tcfg = t_smoke(ARCH)
    jp = jax.jit(lambda key: j_init(jcfg, key))(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jr, tr = make_reports(jcfg, tcfg, jp, tp)
    policy = (8, 4)
    jbits = j_bits_from(jr, JPolicy(allowed_bits=policy), AVG_BITS)
    jq, _ = j_quantize(jp, jbits, JPolicy(allowed_bits=policy), group_size=GROUP)
    tq, _ = t_quantize(tp, bit_config_from_reference(jbits),
                       TPolicy(allowed_bits=policy), group_size=GROUP,
                       device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jr=jr, tr=tr,
                jbits=jbits, jq=jq, tq=tq)


# --------------------------------------------------------------------------
# the module's pieces
# --------------------------------------------------------------------------

def test_ssd_chunked_matches_reference():
    """S = 40 over chunks of 16 (a padded last chunk), a given initial
    state: the outputs and the final state within 1e-5 absolute. The
    inputs are scaled as a model's are (B and C leave a SiLU of a small
    conv), so the outputs are O(1) and 1e-5 is some 10 fp32 ulps."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 2, 40, 3, 8, 6
    xs = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,)) * 0.3).astype(np.float32)
    Bm = (0.3 * rng.normal(size=(b, s, n))).astype(np.float32)
    Cm = (0.3 * rng.normal(size=(b, s, n))).astype(np.float32)
    h0 = (0.3 * rng.normal(size=(b, h, n, p))).astype(np.float32)
    ssd = jax.jit(jm.ssd_chunked, static_argnums=5)
    jy, jh = ssd(*map(jnp.asarray, (xs, dt, A, Bm, Cm)), 16, jnp.asarray(h0))
    ty, th = tm.ssd_chunked(*map(torch.from_numpy, (xs, dt, A, Bm, Cm)), 16,
                            h_init=torch.from_numpy(h0))
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(th.numpy(), _np(jh), atol=1e-5, rtol=0)
    # no initial state, one whole chunk
    jy, jh = ssd(*map(jnp.asarray, (xs, dt, A, Bm, Cm)), 64)
    ty, th = tm.ssd_chunked(*map(torch.from_numpy, (xs, dt, A, Bm, Cm)), 64)
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(th.numpy(), _np(jh), atol=1e-5, rtol=0)


def test_ssd_gradient_finite_past_exp_overflow():
    """A chunk of 128 steps at dt = 1, A = −1: the summed decay (127)
    overflows exp above the causal diagonal. The forward equals the
    reference's; the port's gradient is finite, where the reference's
    (a where() taken after the exp) is NaN (ROADMAP § C, R4)."""
    rng = np.random.default_rng(9)
    b, s, h, p, n = 1, 128, 2, 4, 4
    xs = (0.3 * rng.normal(size=(b, s, h, p))).astype(np.float32)
    dt = np.ones((b, s, h), np.float32)
    A = -np.ones((h,), np.float32)
    Bm = (0.3 * rng.normal(size=(b, s, n))).astype(np.float32)
    Cm = (0.3 * rng.normal(size=(b, s, n))).astype(np.float32)
    jy, _ = jm.ssd_chunked(*map(jnp.asarray, (xs, dt, A, Bm, Cm)), 128)
    # the gradient with respect to dt: dt feeds the decays' cumsum
    jg = jax.grad(lambda d: jnp.sum(jm.ssd_chunked(
        jnp.asarray(xs), d, *map(jnp.asarray, (A, Bm, Cm)), 128)[0]))(
            jnp.asarray(dt))
    assert np.isnan(_np(jg)).any()
    tdt = torch.from_numpy(dt).requires_grad_(True)
    ty, _ = tm.ssd_chunked(torch.from_numpy(xs), tdt,
                           *map(torch.from_numpy, (A, Bm, Cm)), 128)
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), atol=1e-5, rtol=0)
    (tg,) = torch.autograd.grad(ty.sum(), tdt)
    assert torch.isfinite(tg).all() and tg.abs().sum() > 0
    # the same function at a chunk of 16 (summed decays up to 15: no
    # overflow) gives the same gradient, in the port and in the reference
    tdt16 = torch.from_numpy(dt).requires_grad_(True)
    ty16, _ = tm.ssd_chunked(torch.from_numpy(xs), tdt16,
                             *map(torch.from_numpy, (A, Bm, Cm)), 16)
    (tg16,) = torch.autograd.grad(ty16.sum(), tdt16)
    jg16 = jax.grad(lambda d: jnp.sum(jm.ssd_chunked(
        jnp.asarray(xs), d, *map(jnp.asarray, (A, Bm, Cm)), 16)[0]))(
            jnp.asarray(dt))
    assert np.isfinite(_np(jg16)).all()
    np.testing.assert_allclose(tg.numpy(), tg16.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tg.numpy(), _np(jg16), atol=1e-5, rtol=0)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    want = jm._causal_conv(*map(jnp.asarray, (x, w, b)))
    got = tm._causal_conv(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)
    # causal: position t sees only x[:t+1]
    x2 = x.copy()
    x2[:, 6:] = 0.0
    got2 = tm._causal_conv(*map(torch.from_numpy, (x2, w, b)))
    np.testing.assert_array_equal(got2[:, :6].numpy(), got[:, :6].numpy())


def test_mamba2_decode_matches_reference_in_place(model):
    """One recurrence step from a random state: the output, h and the conv
    tail within 1e-5, the state written into the tensors it was given."""
    cfg, jcfg = model["tcfg"], model["jcfg"]
    rng = np.random.default_rng(2)
    prm_j = model["jp"]["layers"]["1"]["mixer"]
    prm_t = model["tp"]["layers"]["1"]["mixer"]
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    h0 = rng.normal(size=(3, cfg.ssm_heads, cfg.ssm_state,
                          cfg.ssm_headdim)).astype(np.float32)
    c0 = rng.normal(size=(3, cfg.conv_width - 1,
                          tm._conv_channels(cfg))).astype(np.float32)
    from repro.models.context import Context as JContext
    from repro_torch.models.context import Context
    jo, js_ = jax.jit(lambda xx, st: jm.mamba2_decode(xx, prm_j, jcfg, JContext(),
                                                      st))(
        jnp.asarray(x), jm.MambaState(jnp.asarray(h0), jnp.asarray(c0)))
    st = tm.MambaState(torch.from_numpy(h0.copy()), torch.from_numpy(c0.copy()))
    with torch.no_grad():
        to, ts_ = tm.mamba2_decode(torch.from_numpy(x), prm_t, cfg, Context(), st)
    np.testing.assert_allclose(to.numpy(), _np(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.h.numpy(), _np(js_.h), atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.conv.numpy(), _np(js_.conv), atol=1e-5, rtol=0)
    assert ts_.h is st.h and ts_.conv is st.conv


def test_forward_and_loss_match(model):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, model["tcfg"].vocab_size, (2, 40)).astype(np.int32)
    jin = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    tin = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    jl, jloss = jax.jit(lambda p, i: (j_forward(p, i, model["jcfg"])[0],
                                      j_loss(p, i, model["jcfg"])))(model["jp"], jin)
    with torch.no_grad():
        tl, aux = t_forward(model["tp"], tin, model["tcfg"])
        tloss = t_loss(model["tp"], tin, model["tcfg"])
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=1e-5, atol=1e-6)
    assert float(aux) == 0.0
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_loss_decreases_under_sgd(model):
    cfg = model["tcfg"]
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    params = {k: v for k, v in named_leaves(model["tp"])}
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    from repro_torch.utils.pytree import map_with_names
    tree = map_with_names(lambda n, _: leaves[n], model["tp"])
    losses = []
    for _ in range(8):
        loss = t_loss(tree, batch, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        assert all(torch.isfinite(g).all() for g in grads)
        with torch.no_grad():
            for v, g in zip(leaves.values(), grads):
                v -= 0.05 * g
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0], losses


def test_grad_barrier_casts_the_cotangent():
    """Identity forward; the backward hands a bf16 input a bf16 cotangent
    (the reference's rounding of the fp32 one), and on a bf16 variant of
    the smoke config every barrier's backward returns bf16."""
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 7)).astype(
        np.float32)).to(torch.bfloat16)
    assert torch.equal(grad_barrier(x), x)
    g32 = torch.from_numpy(np.random.default_rng(6).normal(size=(3, 7)).astype(
        np.float32))
    got = _GradBarrier.backward(types.SimpleNamespace(in_dtype=torch.bfloat16),
                                g32)
    _, vjp = jax.vjp(j_grad_barrier, jnp.asarray(x.float().numpy(), jnp.bfloat16))
    want = vjp(jnp.asarray(g32.numpy()).astype(jnp.bfloat16))[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  _np(want).astype(np.float32))

    cfg = dataclasses.replace(t_smoke(ARCH), dtype="bfloat16")
    from repro_torch.models.transformer import init_params
    params = init_params(cfg, seed=0, device="cpu")
    leaves = {n: v.requires_grad_(True) for n, v in named_leaves(params)}
    seen = []
    orig = _GradBarrier.backward

    def spy(ctx, g):
        out = orig(ctx, g)
        seen.append((ctx.in_dtype, out.dtype))
        return out

    toks = torch.arange(2 * 24, dtype=torch.int32).reshape(2, 24) % cfg.vocab_size
    try:
        _GradBarrier.backward = staticmethod(spy)
        loss = t_loss(params, {"tokens": toks, "labels": toks}, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        _GradBarrier.backward = staticmethod(orig)
    assert len(seen) == 5 * cfg.num_layers
    assert all(i == o == torch.bfloat16 for i, o in seen)
    for (name, leaf), g in zip(leaves.items(), grads):
        assert g.dtype == leaf.dtype and torch.isfinite(g).all(), name


def test_prefill_matches_forward_and_reference(model):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 32)
                                             ).astype(np.int32)
    with torch.no_grad():
        full, _ = t_forward(model["tp"], {"tokens": torch.from_numpy(toks)}, tcfg)
        dec, st = tdec.prefill(model["tp"], {"tokens": torch.from_numpy(toks)},
                               tcfg, 40)
    rel = (full - dec).abs().max().item() / full.abs().max().item()
    assert rel < 2e-3, rel
    jl, js_ = jax.jit(lambda p, t: jdec.prefill(p, {"tokens": t}, jcfg, 40))(
        model["jp"], jnp.asarray(toks))
    np.testing.assert_allclose(dec.numpy(), _np(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.ssm.h.numpy(), _np(js_.ssm.h), atol=1e-5)
    np.testing.assert_allclose(st.ssm.conv.numpy(), _np(js_.ssm.conv), atol=1e-5)
    assert st.kv is None and int(st.pos) == 32
    # a T > 1 step is refused, as in the reference
    with pytest.raises(ValueError, match="rollback-able"):
        tdec.decode_step(model["tp"], st, torch.zeros((2, 2), dtype=torch.int32),
                         tcfg)


def test_state_insert_slot(model):
    """A batch-1 prefilled state lands in slot 1 whole (h and conv tail of
    every layer), the other slots untouched; a stale slot is overwritten."""
    cfg = model["tcfg"]
    big = tdec.init_decode_state(cfg, 3, 16, per_slot_pos=True, device="cpu")
    big.ssm.h.fill_(7.0)
    big.ssm.conv.fill_(-3.0)
    sub = tdec.init_decode_state(cfg, 1, 16, device="cpu")
    with torch.no_grad():
        _, sub = tdec.prefill_into(model["tp"], sub,
                                   torch.zeros((1, 5), dtype=torch.int32), cfg)
    merged = tdec.state_insert_slot(cfg, big, sub, 1)
    assert merged.pos.tolist() == [0, 5, 0]
    assert torch.equal(merged.ssm.h[:, 1], sub.ssm.h[:, 0])
    assert torch.equal(merged.ssm.conv[:, 1], sub.ssm.conv[:, 0])
    assert (merged.ssm.h[:, 0] == 7.0).all() and (merged.ssm.h[:, 2] == 7.0).all()
    assert (merged.ssm.conv[:, 2] == -3.0).all()


# --------------------------------------------------------------------------
# FIT: report, allocation, packed weights, QAT
# --------------------------------------------------------------------------

def test_report_matches(model):
    jr, tr = model["jr"], model["tr"]
    check_reports(jr, tr)
    for i in range(model["tcfg"].num_layers):
        for site in ("conv_out", "ssd_out"):
            assert f"layers/{i}/mixer/{site}" in tr.act_traces
        assert f"layers/{i}/mixer/wdt" in tr.weight_traces


def test_allocations_and_qtensors_identical(model):
    jr = model["jr"]
    tr = SensitivityReport.from_json(jr.to_json())
    tb = t_bits_from(tr, TPolicy(allowed_bits=(8, 4)), AVG_BITS)
    jb = model["jbits"]
    assert (tb.weight_bits, tb.act_bits) == (jb.weight_bits, jb.act_bits)
    total = sum(jr.param_sizes.values())
    tg = t_greedy(tr, TPolicy(), AVG_BITS * total)
    jg = j_greedy(jr, JPolicy(), AVG_BITS * total)
    assert (tg.weight_bits, tg.act_bits) == (jg.weight_bits, jg.act_bits)
    n_packed = check_qtensors(model["jq"], model["tq"])
    # the five projections and out_proj a layer, and the head; the conv
    # and SSM vectors stay fp32
    assert n_packed == 6 * model["tcfg"].num_layers + 1
    mixer = model["tq"]["layers"]["0"]["mixer"]
    for leaf in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w"):
        assert mixer[leaf].dtype == torch.float32, leaf


def test_uniform_levels_and_qat(model):
    cfg = model["tcfg"]
    tq3 = t_uniform_levels(cfg, 3, 3, device="cpu")
    jq3 = j_uniform_levels(model["jcfg"], 3, 3)
    for t, j in ((tq3.layer_weights, jq3.layer_weights),
                 (tq3.layer_acts, jq3.layer_acts)):
        assert sorted(t) == sorted(j)
        for k in j:
            np.testing.assert_array_equal(t[k].numpy(), _np(j[k]))
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    base = float(t_loss(model["tp"], batch, cfg))
    leaves = {n: v.clone().requires_grad_(True)
              for n, v in named_leaves(model["tp"])}
    from repro_torch.utils.pytree import map_with_names
    tree = map_with_names(lambda n, _: leaves[n], model["tp"])
    lq = t_loss(tree, batch, cfg, qat=tq3)
    assert np.isfinite(float(lq.detach())) and abs(float(lq.detach()) - base) > 1e-6
    grads = torch.autograd.grad(lq, list(leaves.values()), allow_unused=True)
    gn = sum(float(g.abs().sum()) for g in grads if g is not None)
    assert np.isfinite(gn) and gn > 0


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _requests(cfg, sampling=None, n=5):
    # one prompt length keeps the JAX engine to one prefill shape
    return poisson_requests(cfg, n, rate=0.25, prompt_len=8, gen_len=(4, 12),
                            sampling=sampling, seed=1)


def _streams(fin):
    return [np.asarray(r.output_tokens).tolist() for r in fin]


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_engine_streams_match_jax_engine(model, monkeypatch, mode):
    """Dense serving of the packed tree: streams equal the JAX engine's
    token for token; alone == batched."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    sp = SAMPLING if mode == "sampled" else None
    jsp = None
    if sp is not None:
        from repro.serve import SamplingParams as JSamplingParams
        jsp = JSamplingParams(temperature=sp.temperature, top_k=sp.top_k,
                              top_p=sp.top_p, seed=sp.seed)
    # one-step bursts for the sampled run: one JAX burst shape a mode
    ecfg = dict(ECFG, decode_burst=1 if sp is not None else 4)
    from repro.serve.loadgen import poisson_requests as j_poisson
    jfin, _ = JEngine(model["jq"], model["jcfg"], JEngineConfig(**ecfg)).run(
        j_poisson(model["jcfg"], 5, rate=0.25, prompt_len=8, gen_len=(4, 12),
                  sampling=jsp, seed=1))
    teng = TEngine(model["tq"], model["tcfg"], TEngineConfig(**ecfg),
                   device="cpu")
    tfin, _ = teng.run(_requests(model["tcfg"], sp))
    assert _streams(tfin) == _streams(jfin)
    assert all(r.num_generated == r.max_new_tokens for r in tfin)
    for i in (0, 3):
        alone = [r for r in _requests(model["tcfg"], sp) if r.id == i]
        alone[0].arrival_time = 0.0
        got, _ = teng.run(alone)
        assert _streams(got) == [tfin[i].output_tokens.tolist()]


def test_refusals_match_reference(model, monkeypatch):
    """Paged KV and speculative decoding are refused for the ssm family,
    by the port's engine as by the reference's."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    from repro.kvcache.paged import PagedKVConfig as JPagedKVConfig
    from repro.serve import SpecConfig as JSpecConfig
    from repro_torch.kvcache.paged import PagedKVConfig
    for eng, ecfg_cls, kw in ((JEngine, JEngineConfig, {}),
                              (TEngine, TEngineConfig, {"device": "cpu"})):
        cfg = model["jcfg"] if eng is JEngine else model["tcfg"]
        qp = model["jq"] if eng is JEngine else model["tq"]
        with pytest.raises(ValueError, match="holds no KV cache to page"):
            eng(qp, cfg, ecfg_cls(**dict(ECFG, kv_cache="paged")), **kw)
        spec = (JSpecConfig if eng is JEngine else SpecConfig)(k=4)
        with pytest.raises(ValueError, match="rollback-able"):
            eng(qp, cfg, ecfg_cls(**dict(ECFG, spec=spec)), **kw)
    with pytest.raises(ValueError, match="holds no KV cache"):
        PagedKVConfig.build(model["tcfg"], 32, 2)
    with pytest.raises(ValueError, match="holds no KV cache"):
        JPagedKVConfig.build(model["jcfg"], 32, 2)
    with pytest.raises(ValueError, match="holds no KV cache to page"):
        tdec.init_paged_decode_state(model["tcfg"], None, 2, device="cpu")
