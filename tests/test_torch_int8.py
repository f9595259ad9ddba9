"""The port's int8-backed W8A8 route against the JAX package on the CPU:
the full-K overflow proof, the plain ``int8_matmul`` against the
reference oracle and the Pallas kernel in interpret mode (bit for bit),
``quantize_params_int8`` byte for byte, the ``DequantContext`` int8
route, the engine's greedy streams, and packed == int8-backed storage."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.bounds import require_full_k_safe as j_full_k_safe
from repro.configs import smoke_config as j_smoke
from repro.kernels import ref as jref
from repro.kernels.int8_matmul import int8_matmul_pallas
from repro.models.context import DequantContext as JDequantContext
from repro.models.transformer import forward as j_forward, init_params as j_init
from repro.quant.policy import BitConfig as JBitConfig
from repro.serve.engine import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serve.loadgen import trace_requests as j_trace
from repro.serve.quantized import quantize_params_int8 as j_quantize_int8
from repro.utils.pytree import named_leaves as jnl
from repro_torch.analysis.bounds import require_full_k_safe
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.int8_matmul import (
    SMS, STEP, TILE_ROWS, int8_matmul as k_int8_matmul, launch_plan)
from repro_torch.models.context import DequantContext
from repro_torch.models.transformer import forward as t_forward
from repro_torch.qtensor import QTensor
from repro_torch.quant.policy import BitConfig
from repro_torch.serve import (
    Engine, EngineConfig, quantize_params, quantize_params_int8, trace_requests,
    weight_storage_bytes)
from repro_torch.utils.pytree import named_leaves

TRACE = [(0, 8, 5), (0, 12, 7), (3, 6, 4)]
ECFG = dict(max_slots=2, max_len=64, max_new_tokens=16, prefill_chunk=4,
            decode_burst=4, int8_compute=True)


@pytest.mark.parametrize("k", [1, 2048, 133_144, 133_145, 10**6])
def test_require_full_k_safe_edges(k):
    """127 * 127 * K < 2^31 holds up to K = 133,144, in both packages."""
    def raises(fn):
        try:
            fn(8, 8, k, where="t")
        except ValueError:
            return True
        return False
    assert raises(require_full_k_safe) == raises(j_full_k_safe) == (k > 133_144)


def _operands(m, k, n, seed, scalar):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xs = (np.float32(0.0123) if scalar
          else (rng.random((m, 1)) * 0.02 + 1e-3).astype(np.float32))
    ws = (rng.random((1, n)) * 0.01 + 1e-4).astype(np.float32)
    return xq, wq, xs, ws


@pytest.mark.parametrize("m,k,n,scalar", [(1, 64, 32, False), (4, 128, 96, False),
                                          (3, 70, 50, False), (5, 40, 24, True)])
def test_plain_int8_matmul_bit_equal_to_reference(m, k, n, scalar):
    xq, wq, xs, ws = _operands(m, k, n, seed=m * k + n, scalar=scalar)
    want = np.asarray(jref.int8_matmul(jnp.asarray(xq), jnp.asarray(wq),
                                       jnp.asarray(xs), jnp.asarray(ws)))
    pallas = np.asarray(int8_matmul_pallas(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs), jnp.asarray(ws),
        interpret=True))
    txq, twq = torch.from_numpy(xq), torch.from_numpy(wq)
    dots = ref.int8_dots(txq, twq)
    assert dots.dtype == torch.int32
    np.testing.assert_array_equal(dots.numpy(),
                                  xq.astype(np.int64) @ wq.astype(np.int64))
    plain = ref.int8_matmul(txq, twq, torch.as_tensor(xs), torch.from_numpy(ws))
    wrapped = k_int8_matmul(txq, twq, torch.as_tensor(xs), torch.from_numpy(ws))
    routed = ops.int8_matmul(txq, twq, torch.as_tensor(xs).reshape(-1),
                             torch.from_numpy(ws))
    for got in (plain, wrapped, routed):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pallas, want)


def test_wrapper_refuses_bad_operands():
    x = torch.zeros((1, 133_145), dtype=torch.int8)
    w = torch.zeros((133_145, 1), dtype=torch.int8)
    for fn in (k_int8_matmul, ops.int8_matmul):
        with pytest.raises(ValueError, match="133144"):
            fn(x, w, torch.ones(1), torch.ones(1))
    with pytest.raises(ValueError, match="reduction dims"):
        k_int8_matmul(torch.zeros((2, 8), dtype=torch.int8),
                      torch.zeros((9, 4), dtype=torch.int8), 1.0, torch.ones(4))
    with pytest.raises(ValueError, match="x_scale"):
        k_int8_matmul(torch.zeros((2, 8), dtype=torch.int8),
                      torch.zeros((8, 4), dtype=torch.int8), torch.ones(3),
                      torch.ones(4))


@pytest.mark.parametrize("m,k,n", [(1, 2048, 2048), (4, 2048, 92544),
                                   (4, 8192, 2048), (3, 2056, 1000),
                                   (1, 133_144, 256), (4, 300, 8), (2, 32, 1),
                                   (4, 2048, 1024)])
def test_launch_plan_covers_k(m, k, n):
    """The kernel's one launch: the warps' contiguous runs of k32 steps,
    as the kernel forms them (warp w from w * ceil(steps / warps)), cover
    K exactly once, none empty, each the plan's length; the grid covers
    N and M; 16-column lanes (128-column CTAs) only on the head's N;
    wq/wo's 64 column tiles of 32 run 16 warps each (1,024 warps of
    loads for the card's 132 SMs)."""
    plan = launch_plan(m, k, n)
    steps = -(-k // STEP)
    ipw = -(-steps // plan.warps)
    assert ipw == plan.steps_per_warp
    runs = [range(min(steps, w * ipw), min(steps, (w + 1) * ipw))
            for w in range(plan.warps)]
    assert [s for r in runs for s in r] == list(range(steps))
    assert all(len(r) for r in runs)
    assert (plan.col_tiles - 1) * plan.cols < n <= plan.col_tiles * plan.cols
    assert plan.m_tiles * TILE_ROWS >= m
    assert plan.cols == (128 if n == 92544 else 32)
    assert 1 <= plan.warps <= (4 if plan.cols == 128 else 16)
    if (k, n) == (2048, 2048):
        assert (plan.col_tiles, plan.warps) == (64, 16)
        assert plan.col_tiles * plan.warps >= SMS
    assert launch_plan(m, k, n, sms=SMS) == plan


def _bits_mixed(names):
    return {n: (4 if i % 2 else 8) for i, n in enumerate(names)}


@pytest.fixture(scope="module", params=["internlm2_1_8b", "olmoe_1b_7b"])
def models(request):
    arch = request.param
    jcfg = dataclasses.replace(j_smoke(arch), scan_layers=False)
    jp = j_init(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return arch, jcfg, jp, t_smoke(arch), tp


@pytest.mark.parametrize("mixed", [False, True])
def test_quantize_params_int8_byte_identical(models, mixed):
    _, _, jp, _, tp = models
    bits = BitConfig(_bits_mixed([n for n, _ in named_leaves(tp)]), {}) if mixed else 8
    jbits = JBitConfig(bits.weight_bits, {}) if mixed else 8
    jq, js = j_quantize_int8(jp, jbits)
    tq, ts = quantize_params_int8(tp, bits, device="cpu")
    jl, tl = dict(jnl(jq)), dict(named_leaves(tq))
    assert list(jl) == list(tl)
    for name, a in jl.items():
        assert str(tl[name].dtype).split(".")[-1] == str(a.dtype), name
        np.testing.assert_array_equal(tl[name].numpy(), np.asarray(a))
    assert sorted(js) == sorted(ts) and ts
    for key, s in js.items():
        assert tuple(ts[key].shape) == s.shape, key
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(s))
    n8 = sum(1 for _, a in tl.items() if a.dtype == torch.int8)
    assert n8 == len(ts)
    assert weight_storage_bytes(tq) < weight_storage_bytes(tp)


def test_quantize_params_int8_refuses_scan_stacked_tree():
    stacked = {"layers": {"attn": {"wq": torch.zeros((2, 8, 8))}}}
    with pytest.raises(ValueError, match="unrolled"):
        quantize_params_int8(stacked, 8, device="cpu")
    jp = j_init(j_smoke("internlm2_1_8b"), jax.random.key(0))   # scanned
    with pytest.raises(ValueError, match="unrolled"):
        j_quantize_int8(jp, 8)


@pytest.mark.parametrize("int8_compute", [True, False])
def test_dequant_context_int8_route_matches_reference_forward(models, monkeypatch,
                                                              int8_compute):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    _, jcfg, jp, tcfg, tp = models
    jq, js = j_quantize_int8(jp, 8)
    tq, ts = quantize_params_int8(tp, 8, device="cpu")
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 9)).astype(np.int32)
    want, _ = jax.jit(lambda p, s, t: j_forward(
        p, {"tokens": t}, jcfg,
        ctx=JDequantContext(s, jcfg.param_dtype, int8_compute=int8_compute)))(
            jq, js, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = t_forward(tq, {"tokens": torch.from_numpy(toks)}, tcfg,
                           ctx=DequantContext(ts, tcfg.param_dtype,
                                              int8_compute=int8_compute))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mixed", [False, True])
def test_engine_int8_streams_match_jax_engine(monkeypatch, mixed):
    """Greedy streams of the int8-backed route (int8_compute=True, the
    int8_matmul kernel's route) equal the JAX engine's, at W8 and on a
    mixed W4/W8 BitConfig."""
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    arch = "internlm2_1_8b"
    jcfg = dataclasses.replace(j_smoke(arch), scan_layers=False)
    jp = j_init(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tcfg = t_smoke(arch)
    wb = _bits_mixed([n for n, _ in named_leaves(tp)])
    jq, js = j_quantize_int8(jp, JBitConfig(wb, {}) if mixed else 8)
    tq, ts = quantize_params_int8(tp, BitConfig(wb, {}) if mixed else 8,
                                  device="cpu")
    jfin, _ = JEngine(jq, jcfg, JEngineConfig(**ECFG), scales=js).run(
        j_trace(jcfg, TRACE))
    tfin, _ = Engine(tq, tcfg, EngineConfig(**ECFG), scales=ts,
                     device="cpu").run(trace_requests(tcfg, TRACE))
    assert len(tfin) == len(TRACE)
    for t, j in zip(tfin, jfin):
        assert t.num_generated == t.max_new_tokens
        np.testing.assert_array_equal(t.output_tokens, np.asarray(j.output_tokens))


@pytest.fixture(scope="module")
def port_model():
    cfg = t_smoke("internlm2_1_8b")
    jp = j_init(dataclasses.replace(j_smoke("internlm2_1_8b"), scan_layers=False),
                jax.random.key(0))
    return cfg, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def test_w8_packed_stores_the_int8_backed_bytes(port_model):
    """QTensor W8 at default granularity holds the int8-backed format's
    exact bytes and scales, and dequantizes to the same values."""
    _, tp = port_model
    qp, _ = quantize_params(tp, 8, device="cpu")
    ip, sc = quantize_params_int8(tp, 8, device="cpu")
    n = 0
    for name, leaf in named_leaves(qp):
        if isinstance(leaf, QTensor):
            n += 1
            w8 = dict(named_leaves(ip))[name]
            assert torch.equal(leaf.data, w8)
            assert torch.equal(leaf.scale, sc[name])
            assert torch.equal(leaf.dequantize(torch.float32),
                               w8.to(torch.float32) * sc[name])
    assert n == 15


@pytest.mark.parametrize("mixed", [False, True])
def test_engine_packed_equals_int8_backed(port_model, mixed):
    """Packed and int8-backed trees of the same BitConfig dequantize to the
    same grid: identical engine outputs on the fp-dequant route, at less
    weight memory for the packed W4 blocks."""
    cfg, tp = port_model
    bits = BitConfig(_bits_mixed([n for n, _ in named_leaves(tp)]), {}) if mixed else 8
    qp, sc = quantize_params_int8(tp, bits, device="cpu")
    qtp, _ = quantize_params(tp, bits, device="cpu")
    for name, leaf in named_leaves(qtp):
        if isinstance(leaf, QTensor):
            w8 = dict(named_leaves(qp))[name]
            assert torch.equal(leaf.dequantize(torch.float32),
                               w8.to(torch.float32) * sc[name]), name
    ecfg = EngineConfig(**dict(ECFG, int8_compute=False))
    fa, _ = Engine(qp, cfg, ecfg, scales=sc, device="cpu").run(trace_requests(cfg, TRACE))
    fb, _ = Engine(qtp, cfg, ecfg, device="cpu").run(trace_requests(cfg, TRACE))
    for a, b in zip(fa, fb):
        np.testing.assert_array_equal(a.output_tokens, b.output_tokens)
    if mixed:
        assert weight_storage_bytes(qtp) < weight_storage_bytes(qp)
