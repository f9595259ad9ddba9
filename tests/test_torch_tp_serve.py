"""Tensor-parallel serving of the port on a CPU mesh: greedy token streams
of the engine at tp 1, 2 and 4 equal to the port's plain engine and to
the JAX engine with ``make_tp_mesh(1)`` (the reference's own tp=N ==
tp=1 contract is its own test), on the internlm2_1_8b smoke config
(paged pools kv-sharded at tp=2, replicated at tp=4; the dense cache),
with prefix sharing and copy-on-write under kv sharding, on olmoe_1b_7b
with expert parallelism, on the int8-backed route, and through
``serve(tp=...)``; and the engine's refusals."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.launch.mesh import make_tp_mesh as j_make_tp_mesh
from repro.models.transformer import init_params as j_init
from repro.serve.engine import Engine as JEngine, EngineConfig as JEngineConfig
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_tp_mesh
from repro_torch.models.decode import decode_step
from repro_torch.quant.policy import BitConfig as TBitConfig
from repro_torch.serve.engine import Engine as TEngine, EngineConfig as TEngineConfig
from repro_torch.serve.loadgen import poisson_requests, trace_requests
from repro_torch.serve.quantized import quantize_params, quantize_params_int8
from repro_torch.utils.pytree import named_leaves
from test_torch_tp import _to_jax
from _torch_threads import _one_thread  # noqa: F401


KV_BITS = {0: 8, 1: 4}
RANGES = {f"layers/{i}/attn/{s}": (-4.0, 3.5) for i in range(2) for s in "kv"}
ECFG = dict(max_slots=3, max_len=48, max_new_tokens=12, prefill_chunk=8,
            decode_burst=4, page_size=8, int8_compute=True,
            prefix_sharing=False)


def _models(arch):
    """JAX and port trees of the same weights, packed at widths cycling
    8/6/4/3 with group 8 (the bytes of both quantizers are equal; the
    JAX tree is the port's bytes)."""
    jcfg = dataclasses.replace(j_smoke(arch), scan_layers=False)
    jp = jax.jit(lambda key: j_init(jcfg, key))(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    names = [n for n, _ in named_leaves(tp)]
    bits = {n: (8, 6, 4, 3)[i % 4] for i, n in enumerate(names)}
    tqp, _ = quantize_params(tp, TBitConfig(bits, {}), group_size=8,
                             device="cpu")
    return jcfg, _to_jax(tqp), t_smoke(arch), tqp, tp


@pytest.fixture(scope="module")
def dense():
    return _models("internlm2_1_8b")


@pytest.fixture(scope="module")
def moe():
    return _models("olmoe_1b_7b")


def _requests(cfg, n=5):
    # one prompt length keeps the JAX engine to one prefill shape
    return poisson_requests(cfg, n, rate=0.25, prompt_len=8, gen_len=(4, 12),
                            seed=1)


def _streams(fin):
    return [np.asarray(r.output_tokens).tolist() for r in fin]


def _paged(kv_cache):
    return dict(kv_bits=KV_BITS, kv_ranges=RANGES) if kv_cache == "paged" else {}


def _plain(cfg, qp, kv_cache, n=5):
    ecfg = TEngineConfig(**dict(ECFG, kv_cache=kv_cache))
    fin, _ = TEngine(qp, cfg, ecfg, device="cpu", **_paged(kv_cache)).run(
        _requests(cfg, n))
    return _streams(fin)


def _sharded(cfg, qp, kv_cache, tp):
    ecfg = TEngineConfig(**dict(ECFG, kv_cache=kv_cache,
                                mesh=make_tp_mesh(tp, "cpu")))
    eng = TEngine(qp, cfg, ecfg, **_paged(kv_cache))
    fin, _ = eng.run(_requests(cfg))
    return eng, _streams(fin)


@pytest.fixture(scope="module")
def dense_plain(dense):
    _, _, tcfg, tqp, _ = dense
    return {kv: _plain(tcfg, tqp, kv) for kv in ("paged", "dense")}


def test_jax_tp1_mesh_engine_equals_port_plain_engine(dense, monkeypatch):
    jcfg, jqp, tcfg, tqp, _ = dense
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    ecfg = JEngineConfig(**dict(ECFG, kv_cache="paged", mesh=j_make_tp_mesh(1)))
    jeng = JEngine(jqp, jcfg, ecfg, **_paged("paged"))
    assert jeng._shard_plan
    jfin, _ = jeng.run(_requests(jcfg, 3))
    assert _streams(jfin) == _plain(tcfg, tqp, "paged", n=3)


@pytest.mark.parametrize("tp,kv_shards", [(1, 1), (2, 2), (4, 1)])
def test_paged_streams_equal_plain_engine(dense, dense_plain, tp, kv_shards):
    """2 kv heads: pools shard one head a shard at tp=2 and stay
    replicated at tp=4 (2 % 4 != 0); every qmm block is planned."""
    _, _, tcfg, tqp, _ = dense
    eng, got = _sharded(tcfg, tqp, "paged", tp)
    assert eng._kv_shards == kv_shards
    assert sorted(set(eng._shard_plan.values())) == ["col", "row"]
    assert got == dense_plain["paged"]


@pytest.mark.parametrize("tp", [2, 4])
def test_dense_cache_streams_equal_plain_engine(dense, dense_plain, tp):
    _, _, tcfg, tqp, _ = dense
    eng, got = _sharded(tcfg, tqp, "dense", tp)
    assert eng._kv_shards == 1
    assert got == dense_plain["dense"]


def test_prefix_sharing_and_cow_under_kv_sharding(dense):
    """A 24-token shared prefix over 16-token pages: a full page shared,
    the boundary page copied on write, in every head shard; the streams
    and the sharing counts equal tp=1's."""
    _, _, tcfg, tqp, _ = dense
    trace = [(0.0, 40, 8), (0.0, 30, 8), (1.0, 35, 8), (2.0, 28, 6)]
    ecfg = dict(max_slots=2, max_len=64, max_new_tokens=8, prefill_chunk=8,
                kv_cache="paged", page_size=16, int8_compute=True, kv_pages=12)
    out = {}
    for tp in (1, 2):
        eng = TEngine(tqp, tcfg, TEngineConfig(**ecfg, mesh=make_tp_mesh(tp, "cpu")),
                      kv_bits=8, kv_ranges=RANGES)
        fin, m = eng.run(trace_requests(tcfg, trace, prefix_len=24))
        s = m.summary()
        out[tp] = (_streams(fin), s["kv_shared_tokens"], s["kv_cow_copies"])
        assert eng._kv_shards == tp
    assert out[1][1] > 0 and out[1][2] > 0
    assert out[2] == out[1]


def test_moe_jax_tp1_mesh_engine_equals_port_expert_parallel(moe, monkeypatch):
    jcfg, jqp, tcfg, tqp, _ = moe
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    jeng = JEngine(jqp, jcfg, JEngineConfig(**dict(
        ECFG, kv_cache="paged", mesh=j_make_tp_mesh(1))), **_paged("paged"))
    jfin, _ = jeng.run(_requests(jcfg, 3))
    eng = TEngine(tqp, tcfg, TEngineConfig(**dict(
        ECFG, kv_cache="paged", mesh=make_tp_mesh(2, "cpu"))), **_paged("paged"))
    got, _ = eng.run(_requests(tcfg, 3))
    assert _streams(got) == _streams(jfin)


@pytest.mark.parametrize("tp", [2, 4])
def test_moe_expert_parallel_streams_equal_plain_engine(moe, tp):
    """8 experts: 8/tp experts a shard through grouped_qmm; 4 kv heads
    shard at both degrees."""
    _, _, tcfg, tqp, _ = moe
    eng, got = _sharded(tcfg, tqp, "paged", tp)
    assert "ep" in eng._shard_plan.values() and eng._kv_shards == tp
    assert got == _plain(tcfg, tqp, "paged")


@pytest.mark.parametrize("tp", [1, 2])
def test_int8_backed_route_streams_equal_plain_engine(dense, tp):
    """int8-backed W8 blocks: columns through int8_matmul per shard, rows
    through exact int32 partial sums and the kernel's epilogue."""
    _, _, tcfg, _, tp_params = dense
    qp, scales = quantize_params_int8(tp_params, 8, device="cpu")
    ecfg = dict(ECFG, kv_cache="paged")
    want, _ = TEngine(qp, tcfg, TEngineConfig(**ecfg), scales=scales,
                      device="cpu", **_paged("paged")).run(_requests(tcfg))
    eng = TEngine(qp, tcfg, TEngineConfig(**ecfg, mesh=make_tp_mesh(tp, "cpu")),
                  scales=scales, **_paged("paged"))
    got, _ = eng.run(_requests(tcfg))
    assert sorted(set(eng._shard_plan.values())) == ["col", "row"]
    assert _streams(got) == _streams(want)


def test_serve_tp2_equals_tp1():
    kw = dict(packed=True, weight_bits=4, group_size=8, paged=True,
              kv_bits=8, n_requests=3, rate=0.5, device="cpu")
    one = tserve.serve("internlm2_1_8b", True, 2, 16, 8, int8_compute=True,
                       tp=1, **kw)
    two = tserve.serve("internlm2_1_8b", True, 2, 16, 8, tp=2, **kw)
    assert two["tp"] == 2 and two["engine"]._kv_shards == 2
    assert two["engine"].ecfg.int8_compute
    assert _streams(two["requests"]) == _streams(one["requests"])
    assert one["shard_weight_bytes"] == one["weight_bytes"]
    assert two["shard_weight_bytes"] < one["shard_weight_bytes"]


def test_quantized_mesh_needs_int8_compute(dense):
    _, _, tcfg, tqp, _ = dense
    with pytest.raises(ValueError, match="int8_compute"):
        TEngine(tqp, tcfg, TEngineConfig(max_slots=2, max_len=32,
                                         mesh=make_tp_mesh(1, "cpu")))


def test_multi_token_decode_under_kv_sharding_raises(dense):
    _, _, tcfg, tqp, _ = dense
    eng = TEngine(tqp, tcfg, TEngineConfig(**dict(
        ECFG, kv_cache="paged", mesh=make_tp_mesh(2, "cpu"))), kv_bits=8)
    state = eng._fresh_state()
    with pytest.raises(NotImplementedError, match="multi-token"):
        decode_step(eng.params, state, torch.zeros((3, 2), dtype=torch.int32),
                    tcfg, ctx=eng._ctx)
