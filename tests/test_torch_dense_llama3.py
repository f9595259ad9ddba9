"""The rest of the dense family in the port against the reference, on
the llama3_8b smoke config (GQA G = 2): EF weight and activation traces,
allocations given the reference's numbers, byte-identical QTensors,
greedy engine streams and ``prefill`` logits. ``make_model`` and these
tests are shared by ``test_torch_dense_phi3.py`` (head_dim 12, G = 1)
and ``test_torch_dense_minitron.py`` (relu2, one kv head, G = 3), which
override the ``model`` fixture."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import build_report as j_build
from repro.core.mpq import greedy_allocate as j_greedy
from repro.data.synthetic import LMStreamConfig, lm_batches
from repro.kvcache.fit import (allocate_kv_bits as j_kv_bits,
                               kv_report_fns as j_kv_fns)
from repro.models import decode as jdec
from repro.models.transformer import init_params as j_init, loss_fn as j_loss
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
from repro_torch.kvcache.fit import (allocate_kv_bits as t_kv_bits,
                                     kv_report_fns as t_kv_fns)
from repro_torch.models import decode as tdec
from repro_torch.models import loss_fn as t_loss
from repro_torch.quant.policy import QuantPolicy as TPolicy
from repro_torch.serve.engine import Engine as TEngine, EngineConfig as TEngineConfig
from repro_torch.serve.loadgen import poisson_requests
from repro_torch.serve.quantized import (bit_config_from_report as t_bits_from,
                                         quantize_params as t_quantize)
from repro_torch.utils.pytree import named_leaves
from _torch_threads import _one_thread  # noqa: F401


ECFG = dict(max_slots=3, max_len=48, max_new_tokens=10, prefill_chunk=8,
            decode_burst=4, kv_cache="paged", page_size=8, int8_compute=True,
            prefix_sharing=False)
AVG_BITS = 6.0
GROUP = 16          # divides every smoke K (48, 64, 96, 128, 144)


def make_model(arch: str) -> dict:
    """Both packages' params, one report each (one batch of 4 x 16,
    microbatch 2), the reference's allocation, KV widths and packed trees."""
    jcfg = dataclasses.replace(j_smoke(arch), scan_layers=False)
    tcfg = t_smoke(arch)
    jp = j_init(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    stream = lm_batches(LMStreamConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                       global_batch=4, seed=0))
    batches = [next(stream)]
    jtl, jts, jaf = j_kv_fns(jcfg)
    jr = j_build(lambda p, b: j_loss(p, b, jcfg), jtl, lambda b: jts(jp, b), jaf,
                 jp, [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
                 microbatch=2, tolerance=None, max_batches=1)
    ttl, tts, taf = t_kv_fns(tcfg)
    tr = t_build(lambda p, b: t_loss(p, b, tcfg), ttl, lambda b: tts(tp, b), taf,
                 tp, batches, microbatch=2, tolerance=None, max_batches=1,
                 device="cpu")
    jbits = j_bits_from(jr, JPolicy(allowed_bits=(8, 4)), AVG_BITS)
    tokens = ECFG["max_slots"] * ECFG["max_len"]
    kv_budget = AVG_BITS / 8.0 * 2 * jcfg.num_layers * tokens \
        * jcfg.num_kv_heads * jcfg.head_dim
    kv_bits = j_kv_bits(jr, jcfg, JPolicy(), kv_budget, tokens)
    jq, _ = j_quantize(jp, jbits, JPolicy(allowed_bits=(8, 4)), group_size=GROUP)
    tq, _ = t_quantize(tp, bit_config_from_reference(jbits),
                       TPolicy(allowed_bits=(8, 4)), group_size=GROUP, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jr=jr, tr=tr, jbits=jbits,
                kv_bits=kv_bits, kv_budget=kv_budget, tokens=tokens, jq=jq, tq=tq)


@pytest.fixture(scope="module")
def model():
    return make_model("llama3_8b")


def test_traces_match(model):
    jr, tr = model["jr"], model["tr"]
    assert list(tr.weight_traces) == list(jr.weight_traces)
    for k, v in jr.weight_traces.items():
        np.testing.assert_allclose(tr.weight_traces[k], v, rtol=1e-4, err_msg=k)
    assert tr.param_sizes == jr.param_sizes
    for k, v in jr.weight_ranges.items():
        np.testing.assert_allclose(tr.weight_ranges[k], v, rtol=0, err_msg=k)
    assert sorted(tr.act_traces) == sorted(jr.act_traces)
    assert len(tr.act_traces) == 2 * model["tcfg"].num_layers     # k and v
    for k, v in jr.act_traces.items():
        np.testing.assert_allclose(tr.act_traces[k], v, rtol=1e-4, err_msg=k)
    for k, v in jr.act_ranges.items():
        np.testing.assert_allclose(tr.act_ranges[k], v, rtol=1e-5, err_msg=k)


def test_allocations_identical_given_reference_numbers(model):
    jr, jcfg, tcfg = model["jr"], model["jcfg"], model["tcfg"]
    tr = SensitivityReport.from_json(jr.to_json())
    tb = t_bits_from(tr, TPolicy(allowed_bits=(8, 4)), AVG_BITS)
    jb = model["jbits"]
    assert (tb.weight_bits, tb.act_bits) == (jb.weight_bits, jb.act_bits)
    assert set(tb.weight_bits.values()) == {4, 8}
    total = sum(jr.param_sizes.values())
    tg = t_greedy(tr, TPolicy(), AVG_BITS * total)
    jg = j_greedy(jr, JPolicy(), AVG_BITS * total)
    assert (tg.weight_bits, tg.act_bits) == (jg.weight_bits, jg.act_bits)
    assert t_kv_bits(tr, tcfg, TPolicy(), model["kv_budget"], model["tokens"]) \
        == model["kv_bits"]


def test_qtensors_byte_identical(model):
    jl = dict(j_named_leaves(model["jq"], is_leaf=j_is_qtensor))
    tl = dict(named_leaves(model["tq"]))
    assert list(jl) == list(tl)
    n_packed = 0
    for name, a in jl.items():
        b = tl[name]
        if j_is_qtensor(a):
            n_packed += 1
            assert (b.bits, b.shape, b.axis) == (a.bits, a.shape, a.axis), name
            np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
            np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    mats = 7 if model["tcfg"].act == "swiglu" else 6
    assert n_packed == mats * model["tcfg"].num_layers + 1       # + head


def _requests(cfg):
    return poisson_requests(cfg, 4, rate=0.25, prompt_len=(3, 14),
                            gen_len=(4, 10), seed=1)


def test_engine_streams_match_jax_engine(model, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    ranges = model["jr"].act_ranges
    jeng = JEngine(model["jq"], model["jcfg"], JEngineConfig(**ECFG),
                   kv_bits=model["kv_bits"], kv_ranges=ranges)
    jfin, _ = jeng.run(_requests(model["jcfg"]))
    teng = TEngine(model["tq"], model["tcfg"], TEngineConfig(**ECFG),
                   kv_bits=model["kv_bits"], kv_ranges=ranges, device="cpu")
    tfin, _ = teng.run(_requests(model["tcfg"]))
    assert [r.id for r in tfin] == [r.id for r in jfin]
    for t, j in zip(tfin, jfin):
        assert t.num_generated == t.max_new_tokens
        np.testing.assert_array_equal(t.output_tokens, np.asarray(j.output_tokens))


def test_prefill_matches(model):
    """``models.decode.prefill`` within the decode tolerance of
    ``test_torch_model.py`` (atol 1e-5 on the logits), and its cache."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 7)
                                             ).astype(np.int32)
    jl, js = jdec.prefill(model["jp"], {"tokens": jnp.asarray(toks)}, jcfg, 32)
    with torch.no_grad():
        tl, ts = tdec.prefill(model["tp"], {"tokens": torch.from_numpy(toks)},
                              tcfg, 32)
    assert tl.shape == (2, 7, jl.shape[-1])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.kv.k.numpy(), np.asarray(js.kv.k), atol=1e-5)
    assert int(ts.pos) == int(js.pos) == 7
