"""The port's MoE serving path against the JAX engine on the olmoe_1b_7b
and deepseek_moe_16b smoke configs: byte-identical packed expert stacks
and greedy token streams (paged and dense KV, int8 compute, grouped
dispatch), and grouped == dense dispatch within the port.

Capacity couples a token to its batch-mates (which tokens an expert
keeps depends on the call's token count and rank order), so on the MoE
path a request served alone need not equal the same request served in
a batch — in the reference as in the port. These tests hold the port to
the reference's own call shapes instead, and to grouped == dense."""
import numpy as np
import pytest
import torch

from repro import qtensor as jq
from repro.quant.policy import BitConfig as JBitConfig, QuantPolicy as JPolicy
from repro.serve.engine import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serve.quantized import quantize_params as j_quantize
from repro.utils.pytree import named_leaves as jnl
from repro_torch.quant.policy import BitConfig as TBitConfig, QuantPolicy as TPolicy
from repro_torch.serve.engine import Engine as TEngine, EngineConfig as TEngineConfig
from repro_torch.serve.loadgen import poisson_requests
from repro_torch.serve.quantized import quantize_params as t_quantize
from repro_torch.utils.pytree import named_leaves
from test_torch_moe import ARCHS, KV_BITS, RANGES, make_models, moe_bits

ECFG = dict(max_slots=3, max_len=48, max_new_tokens=12, prefill_chunk=8,
            decode_burst=2, page_size=8, int8_compute=True,
            prefix_sharing=False)


def _pack(jcfg, jp, tcfg, tp):
    bits = moe_bits([n for n, _ in named_leaves(tp)])
    # eager, as the reference quantizes: under jit XLA may turn its
    # amax / qmax into a reciprocal multiply, one ulp off in a scale
    jqp, _ = j_quantize(jp, JBitConfig(bits, {}), JPolicy(), group_size=16)
    tqp, _ = t_quantize(tp, TBitConfig(bits, {}), TPolicy(), group_size=16,
                        device="cpu")
    return jqp, tqp


@pytest.fixture(scope="module", params=ARCHS)
def packed(request):
    jcfg, jp, tcfg, tp = make_models(request.param)
    jqp, tqp = _pack(jcfg, jp, tcfg, tp)
    return jcfg, jqp, tcfg, tqp


def _requests(cfg, n=4):
    # one prompt length: each JAX engine compiles one prefill shape
    return poisson_requests(cfg, n, rate=0.25, prompt_len=8, gen_len=(4, 12),
                            seed=1)


def test_quantize_params_byte_identical(packed):
    jcfg, jqp, _, tqp = packed
    jl = dict(jnl(jqp, is_leaf=jq.is_qtensor))
    tl = dict(named_leaves(tqp))
    assert list(jl) == list(tl)
    stacks = 0
    for name, a in jl.items():
        b = tl[name]
        if jq.is_qtensor(a):
            stacks += len(a.shape) == 3
            assert (b.bits, b.shape, b.axis) == (a.bits, a.shape, a.axis), name
            np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
            np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
        else:
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert stacks == 3 * jcfg.num_layers
    assert not jq.is_qtensor(jl["layers/0/moe/router"])


@pytest.mark.parametrize("kv_cache", ["paged", "dense"])
def test_engine_streams_match_jax_engine(packed, kv_cache, monkeypatch):
    jcfg, jqp, tcfg, tqp = packed
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    ecfg = dict(ECFG, kv_cache=kv_cache)
    kv = dict(kv_bits=KV_BITS, kv_ranges=RANGES) if kv_cache == "paged" else {}
    jfin, _ = JEngine(jqp, jcfg, JEngineConfig(**ecfg), **kv).run(_requests(jcfg))
    tfin, _ = TEngine(tqp, tcfg, TEngineConfig(**ecfg), device="cpu",
                      **kv).run(_requests(tcfg))
    assert [r.id for r in tfin] == [r.id for r in jfin]
    for t, j in zip(tfin, jfin):
        assert t.num_generated == t.max_new_tokens
        np.testing.assert_array_equal(t.output_tokens, np.asarray(j.output_tokens))


def test_grouped_dispatch_equals_dense_loop(packed):
    """grouped == dense (per-expert qmm loop) greedy streams, bit for bit.
    The einsum dispatch (fp-dequant weights, unquantized activations) is
    other numerics: it is held against the reference's einsum route in
    test_torch_moe.py, not against these streams."""
    _, _, tcfg, tqp = packed
    outs = {}
    for dispatch in ("grouped", "dense"):
        ecfg = TEngineConfig(**dict(ECFG, kv_cache="paged", moe_dispatch=dispatch))
        fin, _ = TEngine(tqp, tcfg, ecfg, kv_bits=KV_BITS, kv_ranges=RANGES,
                         device="cpu").run(_requests(tcfg))
        outs[dispatch] = [r.output_tokens for r in fin]
    assert len(outs["grouped"]) == 4
    for a, b in zip(outs["grouped"], outs["dense"]):
        np.testing.assert_array_equal(a, b)
