"""The port's sampler (``repro_torch.serve.sampling``) against
``repro.serve.sampling``: request keys and uniform bits equal to
``jax.random``'s bit for bit, Gumbel noise within 1e-6, ``sample_tokens``
equal in the greedy / nofilter / full modes and on the reference's edge
cases; then the sampled engine on the internlm2_1_8b smoke config:
streams equal to the JAX engine's (dense and paged), alone == batched,
tp=2 == tp=1 on CPU shards."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models.transformer import init_params as j_init
from repro.quant.policy import BitConfig as JBitConfig, QuantPolicy as JPolicy
from repro.serve import sampling as js
from repro.serve.engine import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serve.quantized import quantize_params as j_quantize
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import params_from_numpy, sampling_tables_from_numpy
from repro_torch.launch.mesh import make_tp_mesh
from repro_torch.quant.policy import BitConfig as TBitConfig, QuantPolicy as TPolicy
from repro_torch.serve import sampling as ts
from repro_torch.serve.engine import Engine as TEngine, EngineConfig as TEngineConfig
from repro_torch.serve.loadgen import poisson_requests
from repro_torch.serve.quantized import quantize_params as t_quantize
from repro_torch.utils.pytree import named_leaves
from _torch_threads import _one_thread  # noqa: F401

ARCH = "internlm2_1_8b"
TOKEN_IDX = np.array([0, 1, 5, 100, 2**31 - 1, 77], np.int32)
KV_BITS = {0: 8, 1: 4}
RANGES = {f"layers/{i}/attn/{s}": (-4.0, 3.5) for i in range(2) for s in "kv"}
ECFG = dict(max_slots=3, max_len=48, max_new_tokens=12, prefill_chunk=8,
            decode_burst=4, page_size=8, int8_compute=True,
            prefix_sharing=False)
SAMPLING = ts.SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=11)


def _keys(seeds, tidx=TOKEN_IDX):
    seeds = np.asarray(seeds, np.int32)
    jk = js.request_keys(jnp.asarray(seeds), jnp.asarray(tidx))
    tk = ts.request_keys(torch.from_numpy(seeds), torch.from_numpy(tidx))
    return jk, tk


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, -1])
def test_request_keys_equal_reference(seed):
    jk, tk = _keys(np.full(len(TOKEN_IDX), seed))
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jk)).astype(np.int64), tk.numpy())


def test_uniform_bits_and_gumbel_match_reference():
    """Bits and the [tiny, 1) uniforms bit for bit; the Gumbel noise
    within 1e-6 (the ulps of log)."""
    jk, tk = _keys([0, 7, 2**31 - 1, -1, 12345, -2**31])
    n = 1000
    jbits = jax.vmap(lambda k: jax.random.bits(k, (n,)))(jk)
    np.testing.assert_array_equal(np.asarray(jbits).astype(np.int64),
                                  ts.random_bits(tk, n).numpy())
    tiny = np.finfo(np.float32).tiny
    ju = jax.vmap(lambda k: jax.random.uniform(k, (n,), minval=tiny))(jk)
    np.testing.assert_array_equal(np.asarray(ju), ts.uniform(tk, n).numpy())
    jg = jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(jk)
    np.testing.assert_allclose(ts.gumbel(tk, n).numpy(), np.asarray(jg),
                               atol=1e-6, rtol=0)


def _sample_both(lg, seeds, tidx, temp, top_k, top_p, skip=False):
    jk, tk = _keys(seeds, tidx)
    want = js.sample_tokens(jnp.asarray(lg), jk, jnp.asarray(temp),
                            jnp.asarray(top_k), jnp.asarray(top_p),
                            skip_filters=skip)
    got = ts.sample_tokens(torch.from_numpy(lg), tk, torch.from_numpy(temp),
                           torch.from_numpy(top_k), torch.from_numpy(top_p),
                           skip_filters=skip)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("mode", ["greedy", "nofilter", "full"])
def test_sample_tokens_match_reference(mode):
    rng = np.random.default_rng(0)
    b = 8
    lg = (rng.normal(size=(b, 1000)) * 3).astype(np.float32)
    seeds = np.arange(b, dtype=np.int32) * 3 - 4
    tidx = np.arange(b, dtype=np.int32) * 17
    temp = np.zeros(b, np.float32) if mode == "greedy" else \
        np.array([0.8, 1.0, 0.5, 2.0, 0.7, 1.3, 0.05, 0.9], np.float32)
    top_k = np.zeros(b, np.int32)
    top_p = np.ones(b, np.float32)
    if mode == "full":
        top_k = np.array([50, 0, 1, 0, 10, 3, 0, 200], np.int32)
        top_p = np.array([0.95, 1.0, 1.0, 0.5, 0.0, 0.9, 0.3, 1.0], np.float32)
    for skip in ((False, True) if mode != "full" else (False,)):
        want, got = _sample_both(lg, seeds, tidx, temp, top_k, top_p, skip)
        np.testing.assert_array_equal(got, want)
    if mode == "greedy":
        np.testing.assert_array_equal(got, lg.argmax(-1))


def test_sampling_edge_cases():
    """The reference's own edge cases (tests/test_serve.py): temperature
    0 is argmax; top_k = 1 and top_p <= 0 collapse to argmax at any
    temperature; ties at the nucleus threshold are all kept; a filterless
    row samples the same with the filters skipped."""
    rng = np.random.default_rng(1)
    lg = rng.normal(size=(4, 101)).astype(np.float32)
    amax = lg.argmax(-1)
    seeds, tidx = np.arange(4, dtype=np.int32), np.zeros(4, np.int32)
    _, tk = _keys(seeds, tidx)
    t = torch.from_numpy(lg)

    def run(temp, k, p, skip=False):
        return ts.sample_tokens(t, tk, torch.full((4,), temp),
                                torch.full((4,), k, dtype=torch.int32),
                                torch.full((4,), p), skip_filters=skip).numpy()

    np.testing.assert_array_equal(run(0.0, 0, 1.0), amax)
    np.testing.assert_array_equal(run(5.0, 1, 1.0), amax)
    for p in (1e-6, 0.0, -0.5):
        np.testing.assert_array_equal(run(3.0, 0, p), amax)
    np.testing.assert_array_equal(run(1.0, 0, 1.0), run(1.0, 0, 1.0, skip=True))
    # 4 tied maxima + tail; top_p = 0.3 crosses the threshold inside the
    # tied group: only tied entries are sampled, more than one of them
    tie = torch.tensor([[2.0, 2.0, 2.0, 2.0] + [0.0] * 60])
    seen = set()
    for i in range(40):
        k = ts.request_keys(torch.zeros(1, dtype=torch.int32),
                            torch.tensor([i], dtype=torch.int32))
        seen.add(int(ts.sample_tokens(tie, k, torch.ones(1),
                                      torch.zeros(1, dtype=torch.int32),
                                      torch.tensor([0.3]))[0]))
    assert seen <= {0, 1, 2, 3} and len(seen) > 1


# --------------------------------------------------------------------------
# the sampled engine
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def packed():
    jcfg = dataclasses.replace(j_smoke(ARCH), scan_layers=False)
    jp = jax.jit(lambda key: j_init(jcfg, key))(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    bits = {n: (4 if "mlp" in n or n == "head" else 8)
            for n, _ in named_leaves(tp)}
    jq, _ = j_quantize(jp, JBitConfig(bits, {}), JPolicy(), group_size=16)
    tq, _ = t_quantize(tp, TBitConfig(bits, {}), TPolicy(), group_size=16,
                       device="cpu")
    return jcfg, jq, t_smoke(ARCH), tq


def _requests(cfg, n=5):
    # one prompt length keeps the JAX engine to one prefill shape
    return poisson_requests(cfg, n, rate=0.25, prompt_len=8, gen_len=(4, 12),
                            sampling=SAMPLING, seed=1)


def _streams(fin):
    return [np.asarray(r.output_tokens).tolist() for r in fin]


def _paged(kv_cache):
    return dict(kv_bits=KV_BITS, kv_ranges=RANGES) if kv_cache == "paged" else {}


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_sampled_engine_streams_match_jax_engine(packed, monkeypatch, kv_cache):
    """Sampled (full mode) streams equal the JAX engine's token for
    token; greedy serving of the same requests differs from them."""
    jcfg, jq, tcfg, tq = packed
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    # one-step bursts: the JAX engine compiles one burst shape a mode
    ecfg = dict(ECFG, kv_cache=kv_cache, decode_burst=1)
    jeng = JEngine(jq, jcfg, JEngineConfig(**ecfg), **_paged(kv_cache))
    jfin, _ = jeng.run(_requests(jcfg))
    teng = TEngine(tq, tcfg, TEngineConfig(**ecfg), device="cpu",
                   **_paged(kv_cache))
    tfin, _ = teng.run(_requests(tcfg))
    assert _streams(tfin) == _streams(jfin)
    # the per-slot sampling tables the runs left behind
    want = sampling_tables_from_numpy(jax.tree.map(np.asarray, jeng._dslots),
                                      device="cpu")
    for name, table in want.items():
        assert torch.equal(getattr(teng, "_" + name), table), name
    greedy = [r for r in _requests(tcfg)]
    for r in greedy:
        r.sampling = ts.SamplingParams()
    gfin, _ = teng.run(greedy)
    assert _streams(gfin) != _streams(tfin)


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_sampled_alone_equals_batched_and_deterministic(packed, kv_cache):
    _, _, tcfg, tq = packed
    eng = TEngine(tq, tcfg, TEngineConfig(**dict(ECFG, kv_cache=kv_cache)),
                  device="cpu", **_paged(kv_cache))
    batched, _ = eng.run(_requests(tcfg))
    again, _ = eng.run(_requests(tcfg))
    assert _streams(again) == _streams(batched)
    for i in (0, 3):
        alone = [r for r in _requests(tcfg) if r.id == i]
        alone[0].arrival_time = 0.0
        got, _ = eng.run(alone)
        assert _streams(got) == [batched[i].output_tokens.tolist()]


def test_sampled_tp2_equals_tp1(packed):
    """Sampled streams at tp=2 (two CPU shards, pools kv-sharded) equal
    the plain engine's."""
    _, _, tcfg, tq = packed
    ecfg = dict(ECFG, kv_cache="paged")
    plain, _ = TEngine(tq, tcfg, TEngineConfig(**ecfg), device="cpu",
                       **_paged("paged")).run(_requests(tcfg))
    eng = TEngine(tq, tcfg, TEngineConfig(**ecfg, mesh=make_tp_mesh(2, "cpu")),
                  **_paged("paged"))
    tp2, _ = eng.run(_requests(tcfg))
    assert eng._kv_shards == 2
    assert _streams(tp2) == _streams(plain)
