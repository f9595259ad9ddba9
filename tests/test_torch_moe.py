"""The port's MoE model slice against the JAX package on the olmoe_1b_7b
and deepseek_moe_16b smoke configs: quantize_experts bytes, the grouped
ragged qmm (plain version vs the JAX oracle and the Pallas kernel in
interpret mode, and vs the port's per-expert qmm loop), moe_apply with
its aux loss, loss/logits, decode/prefill logits, multi-token decode
and the einsum dispatch. The FIT report is in ``test_torch_moe_fit.py``,
serving in ``test_torch_moe_serve.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import qtensor as jq
from repro.configs import smoke_config as j_smoke
from repro.data.synthetic import LMStreamConfig, lm_batches
from repro.kernels import ref as jref
from repro.kernels.grouped_qmm import grouped_qmm_pallas
from repro.models import decode as jdec
from repro.models.context import Context as JContext
from repro.models.moe import _moe_apply_auto as j_moe_apply
from repro.models.transformer import (forward as j_forward, init_params as j_init,
                                      loss_fn as j_loss)
from repro.models.context import DequantContext as JDequantContext
from repro_torch import qtensor as tq
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import grouped_qmm as kgq, ops
from repro_torch.models import decode as tdec
from repro_torch.models.context import Context, DequantContext
from repro_torch.models.moe import moe_apply as t_moe_apply
from repro_torch.models.transformer import forward as t_forward, loss_fn as t_loss
from repro_torch.quant.policy import BitConfig as TBitConfig, QuantPolicy as TPolicy
from repro_torch.utils.pytree import named_leaves
from repro_torch.serve.quantized import quantize_params as t_quantize
from _torch_threads import _one_thread  # noqa: F401


ARCHS = ["olmoe_1b_7b", "deepseek_moe_16b"]
GS = {8: 8, 7: 8, 6: 4, 5: 8, 4: 4, 3: 8}     # pack-unit-aligned group sizes
B, MAX_LEN, PAGE = 2, 32, 8
KV_BITS = {0: 8, 1: 4}
RANGES = {f"layers/{i}/attn/{s}": (-4.0, 3.5) for i in range(2) for s in "kv"}


def moe_bits(names):
    """W4 experts and head, W8 elsewhere (the router stays fp: pinned)."""
    return {n: (4 if "moe" in n or n == "head" else 8) for n in names}


def make_models(arch):
    # the JAX side runs under jit throughout: eager dispatch of the MoE
    # graph costs seconds per call on the CPU
    jcfg = dataclasses.replace(j_smoke(arch), scan_layers=False)
    jp = jax.jit(lambda key: j_init(jcfg, key))(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, t_smoke(arch), tp


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return make_models(request.param)


@pytest.fixture(scope="module")
def packed(model):
    """The port's packed tree and the same bytes as JAX QTensors (the
    byte identity of the two quantizers is tested with the engine)."""
    jcfg, jp, tcfg, tp = model
    bits = moe_bits([n for n, _ in named_leaves(tp)])
    tqp, _ = t_quantize(tp, TBitConfig(bits, {}), TPolicy(), group_size=16,
                        device="cpu")

    def to_jax(node):
        if isinstance(node, dict):
            return {k: to_jax(v) for k, v in node.items()}
        if isinstance(node, tq.QTensor):
            return jq.QTensor(jnp.asarray(node.data.numpy()),
                              jnp.asarray(node.scale.numpy()), node.bits,
                              node.shape, node.axis)
        return jnp.asarray(node.numpy())

    return jcfg, to_jax(tqp), tcfg, tqp


def _tokens(n, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, n)).astype(np.int32)


# --------------------------------------------------------------------------
# quantize_experts / the grouped kernel's plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bits", (8, 7, 6, 5, 4, 3))
def test_quantize_experts_byte_identical(bits):
    w = np.random.default_rng(bits).normal(size=(5, 24, 16)).astype(np.float32)
    jw = jq.quantize_experts(jnp.asarray(w), bits, group_size=GS[bits])
    tw = tq.quantize_experts(torch.from_numpy(w), bits, group_size=GS[bits])
    assert (tw.bits, tw.shape, tw.axis) == (jw.bits, jw.shape, jw.axis)
    assert tuple(tw.scale.shape) == (5, 24 // GS[bits], 16)
    np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    for e in range(5):
        single = tq.quantize(torch.from_numpy(w[e]), bits, group_size=GS[bits])
        sl = tq.expert_slice(tw, e)
        assert (sl.shape, sl.axis, sl.bits) == ((24, 16), 0, bits)
        assert torch.equal(sl.data, single.data) and torch.equal(sl.scale, single.scale)
    s = tq.storage_summary({"moe": {"w_up": tw}})
    assert s["fp16_bytes"] == 2 * 5 * 24 * 16
    assert s["packed_bytes"] == tw.nbytes + tw.scale_bytes
    assert s["predicted_bytes"] == bits * 5 * 24 * 16 / 8


def _grouped_case(bits, c=5, e=6, k=16, n=24):
    rng = np.random.default_rng(10 + bits)
    w = rng.normal(size=(e, k, n)).astype(np.float32)
    x = rng.integers(-127, 128, size=(e, c, k)).astype(np.int8)
    xs = (rng.random((e, c, 1)) * 0.05 + 0.01).astype(np.float32)
    counts = np.array([c, 0, 2, c - 1, 1, 0], np.int32)[:e]
    ids = rng.permutation(e).astype(np.int32)
    return w, x, xs, counts, ids


@pytest.mark.parametrize("bits", (8, 6, 4, 3))
def test_grouped_qmm_matches_jax(bits):
    w, x, xs, counts, ids = _grouped_case(bits)
    gs = 8 if bits in (8, 3) else 4
    jw = jq.quantize_experts(jnp.asarray(w), bits, group_size=gs)
    tw = tq.quantize_experts(torch.from_numpy(w), bits, group_size=gs)
    targs = (torch.from_numpy(x), tw, torch.from_numpy(xs),
             torch.from_numpy(counts), torch.from_numpy(ids))
    y, dots = kgq.grouped_qmm(*targs, return_dots=True)
    # exact int32 group dots of every row against its segment's expert
    s, c, k = x.shape
    g = k // gs
    wi = np.asarray(jw.unpack()).astype(np.int64)[ids]             # (S, K, N)
    want_dots = np.einsum("scgk,sgkn->sgcn", x.astype(np.int64).reshape(s, c, g, gs),
                          wi.reshape(s, g, gs, -1))
    np.testing.assert_array_equal(dots.numpy(), want_dots)
    jargs = (jnp.asarray(x), jw, jnp.asarray(xs), jnp.asarray(counts),
             jnp.asarray(ids))
    want = np.asarray(jref.grouped_qmm(*jargs))
    tol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=tol)
    pal = np.asarray(grouped_qmm_pallas(
        jnp.asarray(x), jw.data, jnp.asarray(xs), jw.scale, jnp.asarray(counts),
        jnp.asarray(ids), bits=bits, k=k, interpret=True))
    np.testing.assert_allclose(y.numpy(), pal, rtol=1e-5, atol=tol)
    rows = np.arange(c)[None, :, None]
    assert not y.numpy()[np.broadcast_to(rows >= counts[:, None, None], y.shape)].any()
    assert torch.equal(ops.grouped_qmm(*targs), y)


@pytest.mark.parametrize("bits", (8, 6, 4, 3))
def test_grouped_plain_equals_qmm_loop(bits):
    """Segment s's valid rows are the port's qmm on expert_slice(w, ids[s]),
    bit for bit; every other row is exact 0.0."""
    w, x, xs, counts, ids = _grouped_case(bits, c=7, k=32)
    tw = tq.quantize_experts(torch.from_numpy(w), bits, group_size=8)
    y = ops.grouped_qmm(torch.from_numpy(x), tw, torch.from_numpy(xs),
                        torch.from_numpy(counts), torch.from_numpy(ids))
    for s in range(x.shape[0]):
        want = ops.qmm(torch.from_numpy(x[s]), tq.expert_slice(tw, int(ids[s])),
                       torch.from_numpy(xs[s]))
        n = int(counts[s])
        assert torch.equal(y[s, :n], want[:n]), s
        assert torch.equal(y[s, n:], torch.zeros_like(y[s, n:]))


def test_grouped_qmm_validation():
    w = torch.randn(4, 32, 8)
    tw = tq.quantize_experts(w, 8, group_size=16)
    x = torch.zeros((4, 3, 32), dtype=torch.int8)
    xs, cnt = torch.ones((4, 3, 1)), torch.ones(4, dtype=torch.int32)
    shared = tq.quantize(w, 8, group_size=16)          # one (1, G, N) grid
    with pytest.raises(ValueError, match="per-expert"):
        ops.grouped_qmm(x, shared, xs, cnt)
    with pytest.raises(ValueError, match="counts"):
        ops.grouped_qmm(x, tw, xs, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="expert_ids"):
        ops.grouped_qmm(x, tw, xs, cnt, torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="x_scale"):
        ops.grouped_qmm(x, tw, torch.ones((4, 3)), cnt)
    with pytest.raises(ValueError, match="not \\(S, C"):
        ops.grouped_qmm(torch.zeros((4, 3, 16), dtype=torch.int8), tw, xs, cnt)
    split = tq.quantize_experts(torch.randn(2, 24, 8), 6, group_size=12)
    split = dataclasses.replace(split, scale=split.scale.repeat_interleave(2, 1))
    with pytest.raises(ValueError, match="pack unit"):         # 6-wide groups
        ops.grouped_qmm(torch.zeros((2, 1, 24), dtype=torch.int8), split,
                        torch.ones((2, 1, 1)), torch.ones(2, dtype=torch.int32))
    big = tq.quantize_experts(torch.ones((1, 140000, 1)), 8)
    with pytest.raises(ValueError, match="overflow int32"):
        ops.grouped_qmm(torch.zeros((1, 1, 140000), dtype=torch.int8), big,
                        torch.ones((1, 1, 1)), torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="moe_dispatch"):
        DequantContext(None, torch.float32, moe_dispatch="turbo")


def test_params_from_numpy_keeps_fp32_router(model):
    jcfg, jp, tcfg, _ = model
    tp16 = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                             dtype=torch.bfloat16)
    moe = tp16["layers"]["0"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_up"].dtype == torch.bfloat16
    assert tp16["layers"]["0"]["ln1"].dtype == torch.bfloat16
    np.testing.assert_array_equal(moe["router"].numpy(),
                                  np.asarray(jp["layers"]["0"]["moe"]["router"]))


# --------------------------------------------------------------------------
# model: moe_apply, forward, loss
# --------------------------------------------------------------------------

def test_moe_apply_matches(model):
    jcfg, jp, tcfg, tp = model
    x = np.random.default_rng(5).normal(size=(3, 7, jcfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(lambda x, p: j_moe_apply(x, p, jcfg, JContext()))(
        jnp.asarray(x), jp["layers"]["0"]["moe"])
    ty, taux = t_moe_apply(torch.from_numpy(x), tp["layers"]["0"]["moe"], tcfg,
                           Context())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_forward_and_loss_match(model):
    jcfg, jp, tcfg, tp = model
    batch = next(lm_batches(LMStreamConfig(vocab_size=jcfg.vocab_size,
                                           seq_len=24, global_batch=3, seed=2)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, jaux = jax.jit(lambda p, b: j_forward(p, b, jcfg, ctx=JContext()))(jp, jb)
    with torch.no_grad():
        tl, taux = t_forward(tp, tb, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert float(taux) > 0
    np.testing.assert_allclose(
        float(t_loss(tp, tb, tcfg)),
        float(jax.jit(lambda p, b: j_loss(p, b, jcfg))(jp, jb)), rtol=1e-5)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_decode_and_prefill_logits_match(model, kv):
    jcfg, jp, tcfg, tp = model
    if kv == "dense":
        js = jdec.init_decode_state(jcfg, B, MAX_LEN, per_slot_pos=True)
        ts = tdec.init_decode_state(tcfg, B, MAX_LEN, per_slot_pos=True, device="cpu")
    else:
        from repro.kvcache.paged import PagedKVConfig as JP
        from repro_torch.kvcache.paged import PagedKVConfig as TP
        jpc = JP.build(jcfg, MAX_LEN, B, page_size=PAGE, kv_bits=KV_BITS)
        tpc = TP.build(tcfg, MAX_LEN, B, page_size=PAGE, kv_bits=KV_BITS)
        js = jdec.init_paged_decode_state(jcfg, jpc, B, RANGES)
        ts = tdec.init_paged_decode_state(tcfg, tpc, B, RANGES, device="cpu")
        table = np.arange(B * jpc.pages_per_slot, dtype=np.int32).reshape(B, -1)
        js = js._replace(paged=js.paged._replace(
            table=jnp.asarray(table), write_limit=jnp.full((B,), MAX_LEN, jnp.int32)))
        ts.paged.table.copy_(torch.from_numpy(table))
        ts.paged.write_limit.fill_(MAX_LEN)
    # prefill_into is a loop of one-token decode steps on both sides:
    # every position's logits are one decode step's
    toks = _tokens(6, seed=1)
    jl, js = jax.jit(lambda p, s, t: jdec.prefill_into(p, s, t, jcfg))(
        jp, js, jnp.asarray(toks))
    with torch.no_grad():
        tl, ts = tdec.prefill_into(tp, ts, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    assert ts.pos.tolist() == np.asarray(js.pos).tolist()


def test_multi_token_decode_and_einsum_dispatch(packed, monkeypatch):
    """A (B, T) packed decode call routes each query column on its own
    (capacity 1 here, so experts overflow): on the grouped dispatch its
    logits equal T one-token steps bit for bit; on the einsum dispatch
    (fp-dequant experts) they equal the reference's own multi-token call
    within 1e-5."""
    jcfg, jqp, tcfg, tqp = packed
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    toks = torch.from_numpy(_tokens(3, seed=7))
    out = {}
    with torch.no_grad():
        for dispatch in ("grouped", "einsum"):
            ctx = DequantContext(None, tcfg.param_dtype, int8_compute=True,
                                 moe_dispatch=dispatch)
            out[dispatch], _ = tdec.decode_step(
                tqp, tdec.init_decode_state(tcfg, B, MAX_LEN, device="cpu"), toks, tcfg, ctx)
        ctx = DequantContext(None, tcfg.param_dtype, int8_compute=True)
        steps, _ = tdec.prefill_into(
            tqp, tdec.init_decode_state(tcfg, B, MAX_LEN, device="cpu"), toks, tcfg, ctx)
    assert torch.equal(out["grouped"], steps)
    jctx = JDequantContext({}, jcfg.param_dtype, int8_compute=True,
                           moe_dispatch="einsum")
    want, _ = jax.jit(lambda p, s, t: jdec.decode_step(p, s, t, jcfg, ctx=jctx))(
        jqp, jdec.init_decode_state(jcfg, B, MAX_LEN), jnp.asarray(toks.numpy()))
    np.testing.assert_allclose(out["einsum"].numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
