"""Prefix sharing and copy-on-write in the port's paged engine, against
the JAX package on the CPU: the page primitives (``gather_layer``,
``copy_page``), paged fp pages with sharing == the dense cache, and
sharing over int8 KV pages == the JAX engine with sharing."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.kvcache import paged as jpaged
from repro.models.transformer import init_params as j_init
from repro.serve.engine import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serve.loadgen import trace_requests as j_trace
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.kvcache import paged as tpaged
from repro_torch.serve import Engine, EngineConfig, trace_requests

ARCH = "internlm2_1_8b"
# a 24-token shared prompt prefix ends inside a 16-token page: the
# boundary page is shared partially and copied on write
TRACE = [(0, 8, 5), (0, 12, 7), (3, 6, 4), (10, 10, 6), (11, 35, 8)]
ECFG = dict(max_slots=2, max_len=64, max_new_tokens=16, prefill_chunk=4,
            decode_burst=4)
P, PAGE = 6, 4


def _pools(bits, seed=0):
    """The same random pool as a reference and a port LayerPages."""
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jpc = jpaged.PagedKVConfig.build(jcfg, 8, 3, page_size=PAGE, num_pages=P,
                                     kv_bits=bits)
    tpc = tpaged.PagedKVConfig.build(tcfg, 8, 3, page_size=PAGE, num_pages=P,
                                     kv_bits=bits)
    jl = jpaged.init_paged_kv(jcfg, jpc, 3).layers["0"]
    tl = tpaged.init_paged_kv(tcfg, tpc, 3, device="cpu").layers["0"]
    rng = np.random.default_rng(seed)
    if bits >= 16:
        k, v = (rng.normal(size=jl.k.shape).astype(np.float32) for _ in "kv")
    else:
        hi = 256 if jl.k.dtype == jnp.uint8 else 128
        k, v = (rng.integers(-128 if hi == 128 else 0, hi, jl.k.shape)
                .astype(np.dtype(jl.k.dtype)) for _ in "kv")
    ks, vs = ((rng.random(jl.k_scale.shape) * 0.05 + 0.01).astype(np.float32)
              for _ in "kv")
    jl = dataclasses.replace(jl, k=jnp.asarray(k), v=jnp.asarray(v),
                             k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tl.k.copy_(torch.from_numpy(k))
    tl.v.copy_(torch.from_numpy(v))
    tl.k_scale.copy_(torch.from_numpy(ks))
    tl.v_scale.copy_(torch.from_numpy(vs))
    return jl, tl


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("n_tokens", [5, 8])
def test_gather_layer_matches_reference(bits, n_tokens):
    jl, tl = _pools(bits)
    row = np.array([4, 1, P], np.int32)            # the last entry is unmapped
    jk, jv = jpaged.gather_layer(jl, jnp.asarray(row), n_tokens, jnp.float32)
    tk, tv = tpaged.gather_layer(tl, torch.from_numpy(row), n_tokens,
                                 torch.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not tk[n_tokens:].any()


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_copy_page_matches_reference_in_place(bits):
    jl, tl = _pools(bits, seed=1)
    spare = tl.k_buf[P].clone()
    jout = jpaged.copy_page(jl, 2, 5)
    tout = tpaged.copy_page(tl, 2, 5)
    assert tout is tl
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                      np.asarray(getattr(jout, name)))
    # the pool still aliases its write buffer, spare page untouched
    assert tl.k.data_ptr() == tl.k_buf.data_ptr()
    assert tl.v.data_ptr() == tl.v_buf.data_ptr()
    assert torch.equal(tl.k_buf[P], spare)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(j_smoke(ARCH), scan_layers=False)
    jp = j_init(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, t_smoke(ARCH), tp


def test_paged_sharing_equals_dense_cache(models):
    """Staggered arrivals, eviction + backfill and a shared 24-token
    prompt prefix: paged fp pages with sharing give the dense cache's
    greedy streams, and both full-page sharing and a partial COW copy
    happened."""
    _, _, cfg, tp = models
    dense = Engine(tp, cfg, EngineConfig(**ECFG), device="cpu")
    paged = Engine(tp, cfg, EngineConfig(**ECFG, kv_cache="paged", page_size=16),
                   device="cpu")
    assert paged.ecfg.prefix_sharing                  # the default
    fd, _ = dense.run(trace_requests(cfg, TRACE, prefix_len=24))
    fp, mp = paged.run(trace_requests(cfg, TRACE, prefix_len=24))
    assert len(fp) == len(TRACE)
    for a, b in zip(fd, fp):
        np.testing.assert_array_equal(a.output_tokens, b.output_tokens)
    s = mp.summary()
    assert s["kv_shared_tokens"] > 0
    assert s["kv_cow_copies"] > 0
    assert mp.kv_total_pages == 8                    # (64/16) pages x 2 slots


def test_sharing_over_int8_pages_matches_jax_engine(models, monkeypatch):
    """With int8 KV pages a shared prefix is read back dequantized, so
    the streams are the sharing route's own; they equal the JAX engine's
    with sharing, with the same shared-token and COW counts."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    jcfg, jp, tcfg, tp = models
    ranges = {f"layers/{i}/attn/{s}": (-4.0, 3.5) for i in range(2) for s in "kv"}
    kw = dict(ECFG, kv_cache="paged", page_size=16)
    jfin, jm = JEngine(jp, jcfg, JEngineConfig(**kw), kv_bits=8,
                       kv_ranges=ranges).run(j_trace(jcfg, TRACE, prefix_len=24))
    tfin, tm = Engine(tp, tcfg, EngineConfig(**kw), kv_bits=8, kv_ranges=ranges,
                      device="cpu").run(trace_requests(tcfg, TRACE, prefix_len=24))
    assert [r.id for r in tfin] == [r.id for r in jfin]
    for t, j in zip(tfin, jfin):
        np.testing.assert_array_equal(t.output_tokens, np.asarray(j.output_tokens))
    js, ts = jm.summary(), tm.summary()
    assert ts["kv_shared_tokens"] == js["kv_shared_tokens"] > 0
    assert ts["kv_cow_copies"] == js["kv_cow_copies"] > 0
    assert ts["kv_peak_pages"] == js["kv_peak_pages"]


@pytest.mark.parametrize("pos", [[6, 2], [7, 9]])
def test_dense_cache_drops_writes_past_its_end(models, pos):
    """Multi-token decode whose positions run past the dense cache
    (T = 8): the writes past it are dropped, as the reference's scatter
    drops them, and the cache and outputs equal the reference's."""
    from repro.models import attention as jatt
    from repro.models.context import Context as JContext
    from repro_torch.models import attention as tatt
    from repro_torch.models.context import Context
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, tcfg.d_model)).astype(np.float32)
    shape = (2, 8, tcfg.num_kv_heads, tcfg.head_dim)
    k0, v0 = (rng.normal(size=shape).astype(np.float32) for _ in "kv")
    pos = np.asarray(pos, np.int32)
    jo, jc = jatt.attention_decode(
        jnp.asarray(x), jp["layers"]["0"]["attn"], jcfg, JContext(),
        jatt.KVCache(jnp.asarray(k0), jnp.asarray(v0)), jnp.asarray(pos))
    tc = tatt.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    with torch.no_grad():
        to, tc = tatt.attention_decode(torch.from_numpy(x), tp["layers"]["0"]["attn"],
                                       tcfg, Context(), tc, torch.from_numpy(pos))
    for got, want, before in ((tc.k, jc.k, k0), (tc.v, jc.v, v0)):
        # new rows differ by fp32 rounding of the projections (1e-7);
        # rows the reference left alone are exactly the old ones
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
        kept = np.asarray(want) == before
        np.testing.assert_array_equal(got.numpy()[kept], before[kept])
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)


def test_dense_engine_burst_past_max_len_matches_jax_engine(models, monkeypatch):
    """Prompt + new tokens == max_len with staggered finishes: a decode
    burst carries a slot past its last cache position; the dense engine
    drops those writes and its streams equal the JAX engine's."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    jcfg, jp, tcfg, tp = models
    trace = [(0.0, 40, 8), (0.0, 30, 8), (0.0, 35, 8)]
    kw = dict(max_slots=3, max_len=48, max_new_tokens=8, prefill_chunk=32)
    jfin, _ = JEngine(jp, jcfg, JEngineConfig(**kw)).run(
        j_trace(jcfg, trace, prefix_len=24))
    tfin, _ = Engine(tp, tcfg, EngineConfig(**kw), device="cpu").run(
        trace_requests(tcfg, trace, prefix_len=24))
    for t, j in zip(tfin, jfin):
        assert t.num_generated == 8
        np.testing.assert_array_equal(t.output_tokens, np.asarray(j.output_tokens))
