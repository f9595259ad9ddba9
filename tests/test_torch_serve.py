"""The port's packed serving path against repro.serve on the smoke config:
byte-identical QTensor blocks, the continuous-batching engine's greedy
token streams (paged, mixed KV bits, int8 compute) equal to the JAX
engine's, batched == alone, and the entry points' refusals."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models.transformer import init_params as j_init
from repro.quant.policy import BitConfig as JBitConfig, QuantPolicy as JPolicy
from repro.serve.engine import Engine as JEngine, EngineConfig as JEngineConfig
from repro.serve.quantized import quantize_params as j_quantize
from repro_torch.configs import ModelConfig, smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.quant.policy import BitConfig as TBitConfig, QuantPolicy as TPolicy
from repro_torch.serve.engine import Engine as TEngine, EngineConfig as TEngineConfig
from repro_torch.serve.loadgen import poisson_requests
from repro_torch.serve.quantized import quantize_params as t_quantize
from repro_torch.serve.sampling import SamplingParams
from repro_torch.utils.pytree import named_leaves
from _torch_threads import _one_thread  # noqa: F401


ARCH = "internlm2_1_8b"
KV_BITS = {0: 8, 1: 4}
RANGES = {f"layers/{i}/attn/{s}": (-4.0, 3.5) for i in range(2) for s in "kv"}
ECFG = dict(max_slots=3, max_len=48, max_new_tokens=12, prefill_chunk=8,
            decode_burst=4, kv_cache="paged", page_size=8, int8_compute=True,
            prefix_sharing=False)


def _bits(names):
    return {n: (4 if "mlp" in n or n == "head" else 8) for n in names}


@pytest.fixture(scope="module")
def packed():
    jcfg = dataclasses.replace(j_smoke(ARCH), scan_layers=False)
    jp = j_init(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    bits = _bits([n for n, _ in named_leaves(tp)])
    jq, _ = j_quantize(jp, JBitConfig(bits, {}), JPolicy(), group_size=16)
    tq, _ = t_quantize(tp, TBitConfig(bits, {}), TPolicy(), group_size=16,
                       device="cpu")
    return jcfg, jq, t_smoke(ARCH), tq


def _requests(cfg, n=5):
    return poisson_requests(cfg, n, rate=0.25, prompt_len=(3, 20),
                            gen_len=(4, 12), seed=1)


def test_quantize_params_byte_identical(packed):
    from repro.qtensor import is_qtensor
    from repro.utils.pytree import named_leaves as jnl
    _, jq, _, tq = packed
    jl = dict(jnl(jq, is_leaf=is_qtensor))
    tl = dict(named_leaves(tq))
    assert list(jl) == list(tl)
    n_packed = 0
    for name, a in jl.items():
        b = tl[name]
        if is_qtensor(a):
            n_packed += 1
            assert (b.bits, b.shape, b.axis) == (a.bits, a.shape, a.axis), name
            np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
            np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert n_packed == 15        # 7 matmuls x 2 layers + head


def test_engine_streams_match_jax_engine(packed, monkeypatch):
    jcfg, jq, tcfg, tq = packed
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    jeng = JEngine(jq, jcfg, JEngineConfig(**ECFG), kv_bits=KV_BITS,
                   kv_ranges=RANGES)
    jfin, _ = jeng.run(_requests(jcfg))
    teng = TEngine(tq, tcfg, TEngineConfig(**ECFG), kv_bits=KV_BITS,
                   kv_ranges=RANGES, device="cpu")
    tfin, tm = teng.run(_requests(tcfg))
    assert [r.id for r in tfin] == [r.id for r in jfin]
    for t, j in zip(tfin, jfin):
        assert t.num_generated == t.max_new_tokens
        np.testing.assert_array_equal(t.output_tokens, np.asarray(j.output_tokens))
    s = tm.summary()
    assert s["n_finished"] == 5 and s["kv_peak_pages"] > 0


@pytest.mark.parametrize("kv_cache", ["paged", "dense"])
def test_request_alone_equals_batched(packed, kv_cache):
    _, _, tcfg, tq = packed
    ecfg = TEngineConfig(**dict(ECFG, kv_cache=kv_cache))
    eng = TEngine(tq, tcfg, ecfg, kv_bits=KV_BITS if kv_cache == "paged" else None,
                  kv_ranges=RANGES, device="cpu")
    batched, _ = eng.run(_requests(tcfg))
    for i in (0, 3):
        alone_req = [r for r in _requests(tcfg) if r.id == i]
        alone_req[0].arrival_time = 0.0
        alone, _ = eng.run(alone_req)
        np.testing.assert_array_equal(alone[0].output_tokens,
                                      batched[i].output_tokens)


def test_entry_points_raise_without_gpu(packed, monkeypatch):
    from repro_torch.core.report import build_report
    from repro_torch.models.transformer import init_params
    _, _, tcfg, tq = packed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_quantize({"layers": {"0": {}}}, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_report(None, None, None, None, {}, [{}])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(tq, tcfg, TEngineConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(2)})


@pytest.mark.parametrize("bad", [dict(spec=object()), dict(obs=object()),
                                 dict(mesh=object())])
def test_unsupported_engine_options_raise(packed, bad):
    """A spec that is not a SpecConfig and an obs that is not an
    ObsConfig raise TypeError, a mesh that is not a TPMesh ValueError
    naming make_tp_mesh."""
    _, _, tcfg, tq = packed
    exc, match = {"spec": (TypeError, "SpecConfig"),
                  "obs": (TypeError, "ObsConfig"),
                  "mesh": (ValueError, "make_tp_mesh")}[next(iter(bad))]
    with pytest.raises(exc, match=match):
        TEngine(tq, tcfg, TEngineConfig(**dict(ECFG, **bad)), device="cpu")


def test_sampled_decoding_and_other_families_raise(packed):
    """Sampled decoding runs (its tokens in the vocab, the same on a
    second run); a family the model does not know is refused with the
    reference's error type (``ValueError``)."""
    _, _, tcfg, tq = packed
    eng = TEngine(tq, tcfg, TEngineConfig(**ECFG), device="cpu")

    def reqs():
        return poisson_requests(tcfg, 1, rate=1.0, prompt_len=4, gen_len=4,
                                sampling=SamplingParams(temperature=0.7))
    a, _ = eng.run(reqs())
    b, _ = eng.run(reqs())
    assert a[0].num_generated == 4
    assert ((a[0].output_tokens >= 0) & (a[0].output_tokens < tcfg.vocab_size)).all()
    np.testing.assert_array_equal(a[0].output_tokens, b[0].output_tokens)
    unknown = ModelConfig(name="m", family="foo", num_layers=1, d_model=8)
    with pytest.raises(ValueError, match="foo"):
        TEngine(tq, unknown, TEngineConfig(), device="cpu")
