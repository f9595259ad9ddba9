"""The port's dense transformer against repro.models on the
internlm2_1_8b smoke config: loss, per-step decode logits (dense and
paged), chunked prefill, and paged == dense within the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.data.synthetic import LMStreamConfig, lm_batches
from repro.kvcache.paged import PagedKVConfig as JPagedKVConfig
from repro.models import decode as jdec
from repro.models.transformer import init_params as j_init, loss_fn as j_loss
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.kvcache.paged import PagedKVConfig as TPagedKVConfig
from repro_torch.models import decode as tdec
from repro_torch.models.transformer import init_params as t_init, loss_fn as t_loss

ARCH = "internlm2_1_8b"
MAX_LEN, PAGE, B = 32, 8, 2


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(j_smoke(ARCH), scan_layers=False)
    jp = j_init(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, t_smoke(ARCH), tp


def _tokens(n, seed=0, vocab=384):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, n)).astype(np.int32)


def test_params_tree_matches(models):
    jcfg, jp, tcfg, tp = models
    from repro.utils.pytree import named_leaves as jnl
    from repro_torch.utils.pytree import named_leaves as tnl
    assert [n for n, _ in jnl(jp)] == [n for n, _ in tnl(tp)]
    fresh = t_init(tcfg, seed=1, device="cpu")
    assert [(n, tuple(a.shape)) for n, a in tnl(fresh)] == \
        [(n, tuple(a.shape)) for n, a in jnl(jp)]


def test_loss_matches(models):
    jcfg, jp, tcfg, tp = models
    batch = next(lm_batches(LMStreamConfig(vocab_size=jcfg.vocab_size,
                                           seq_len=24, global_batch=3, seed=2)))
    want = float(j_loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
    got = float(t_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _paged_states(jcfg, tcfg, kv_bits):
    jp = JPagedKVConfig.build(jcfg, MAX_LEN, B, page_size=PAGE, kv_bits=kv_bits)
    tpc = TPagedKVConfig.build(tcfg, MAX_LEN, B, page_size=PAGE, kv_bits=kv_bits)
    ranges = {f"layers/{i}/attn/{s}": (-3.0, 2.5) for i in range(2) for s in "kv"}
    js = jdec.init_paged_decode_state(jcfg, jp, B, ranges)
    ts = tdec.init_paged_decode_state(tcfg, tpc, B, ranges, device="cpu")
    table = np.arange(B * jp.pages_per_slot, dtype=np.int32)[::-1].reshape(B, -1).copy()
    limit = np.array([MAX_LEN, MAX_LEN - 5], np.int32)
    js = js._replace(paged=js.paged._replace(table=jnp.asarray(table),
                                             write_limit=jnp.asarray(limit)))
    ts.paged.table.copy_(torch.from_numpy(table))
    ts.paged.write_limit.copy_(torch.from_numpy(limit))
    return js, ts


@pytest.mark.parametrize("kv", ["dense", "paged16", "paged_mixed"])
def test_decode_step_logits_match(models, kv):
    jcfg, jp, tcfg, tp = models
    if kv == "dense":
        js = jdec.init_decode_state(jcfg, B, MAX_LEN, per_slot_pos=True)
        ts = tdec.init_decode_state(tcfg, B, MAX_LEN, per_slot_pos=True, device="cpu")
    else:
        bits = 16 if kv == "paged16" else {0: 8, 1: 4}
        js, ts = _paged_states(jcfg, tcfg, bits)
    step = jax.jit(lambda p, s, t: jdec.decode_step(p, s, t, jcfg))
    toks = _tokens(6)
    with torch.no_grad():
        for i in range(toks.shape[1]):
            jl, js = step(jp, js, jnp.asarray(toks[:, i:i + 1]))
            tl, ts = tdec.decode_step(tp, ts, torch.from_numpy(toks[:, i:i + 1]), tcfg)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    assert ts.pos.tolist() == np.asarray(js.pos).tolist()


def test_prefill_into_matches(models):
    jcfg, jp, tcfg, tp = models
    toks = _tokens(7, seed=3)
    js = jdec.init_decode_state(jcfg, B, MAX_LEN)
    ts = tdec.init_decode_state(tcfg, B, MAX_LEN, device="cpu")
    jl, js = jax.jit(lambda p, s, t: jdec.prefill_into(p, s, t, jcfg))(
        jp, js, jnp.asarray(toks))
    with torch.no_grad():
        tl, ts = tdec.prefill_into(tp, ts, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.kv.k.numpy(), np.asarray(js.kv.k), atol=1e-5)
    assert int(ts.pos) == int(js.pos) == 7


def test_paged_equals_dense_within_port(models):
    jcfg, jp, tcfg, tp = models
    dense = tdec.init_decode_state(tcfg, B, MAX_LEN, per_slot_pos=True, device="cpu")
    _, paged = _paged_states(jcfg, tcfg, 16)
    toks = _tokens(9, seed=4)
    with torch.no_grad():
        for i in range(toks.shape[1]):
            t = torch.from_numpy(toks[:, i:i + 1])
            ld, dense = tdec.decode_step(tp, dense, t, tcfg)
            lp, paged = tdec.decode_step(tp, paged, t, tcfg)
            assert torch.equal(ld, lp)


def test_state_insert_slot(models):
    jcfg, jp, tcfg, tp = models
    big = tdec.init_decode_state(tcfg, 3, MAX_LEN, per_slot_pos=True, device="cpu")
    sub = tdec.init_decode_state(tcfg, 1, MAX_LEN, device="cpu")
    with torch.no_grad():
        _, sub = tdec.prefill_into(tp, sub, torch.from_numpy(_tokens(5)[:1]), tcfg)
    tdec.state_insert_slot(tcfg, big, sub, 1)
    assert big.pos.tolist() == [0, 5, 0]
    assert torch.equal(big.kv.k[:, 1], sub.kv.k[:, 0])
    assert not big.kv.k[:, 0].any()
