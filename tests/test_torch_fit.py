"""The port's FIT report and allocators against repro.core on the
internlm2_1_8b smoke config."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import smoke_config as j_smoke
from repro.core import build_report as j_build
from repro.core.mpq import greedy_allocate as j_greedy
from repro.data.synthetic import LMStreamConfig, lm_batches
from repro.kvcache.fit import (allocate_kv_bits as j_kv_bits,
                               kv_report_fns as j_kv_fns)
from repro.models.transformer import init_params as j_init, loss_fn as j_loss
from repro.quant.policy import QuantPolicy as JPolicy
from repro.serve.quantized import bit_config_from_report as j_bits_from
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.fit import SensitivityReport
from repro_torch.core.mpq import greedy_allocate as t_greedy
from repro_torch.core.report import build_report as t_build
from repro_torch.kvcache.fit import (allocate_kv_bits as t_kv_bits,
                                     kv_report_fns as t_kv_fns)
from repro_torch.models.transformer import loss_fn as t_loss
from repro_torch.quant.policy import QuantPolicy as TPolicy
from repro_torch.serve.quantized import bit_config_from_report as t_bits_from
from _torch_threads import _one_thread  # noqa: F401


ARCH = "internlm2_1_8b"


@pytest.fixture(scope="module")
def reports():
    jcfg = dataclasses.replace(j_smoke(ARCH), scan_layers=False)
    tcfg = t_smoke(ARCH)
    jp = j_init(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    stream = lm_batches(LMStreamConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                       global_batch=4, seed=0))
    batches = [next(stream) for _ in range(2)]
    jtl, jts, jaf = j_kv_fns(jcfg)
    jr = j_build(lambda p, b: j_loss(p, b, jcfg), jtl,
                 lambda b: jts(jp, b), jaf, jp,
                 [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
                 microbatch=2, tolerance=None, max_batches=2)
    ttl, tts, taf = t_kv_fns(tcfg)
    tr = t_build(lambda p, b: t_loss(p, b, tcfg), ttl, lambda b: tts(tp, b),
                 taf, tp, batches, microbatch=2, tolerance=None, max_batches=2,
                 device="cpu")
    return jcfg, tcfg, jr, tr


def test_weight_traces_match(reports):
    _, _, jr, tr = reports
    assert list(tr.weight_traces) == list(jr.weight_traces)
    for k, v in jr.weight_traces.items():
        np.testing.assert_allclose(tr.weight_traces[k], v, rtol=1e-4, err_msg=k)
    assert tr.param_sizes == jr.param_sizes
    for k, v in jr.weight_ranges.items():
        np.testing.assert_allclose(tr.weight_ranges[k], v, rtol=0, err_msg=k)


def test_activation_traces_and_ranges_match(reports):
    _, _, jr, tr = reports
    assert sorted(tr.act_traces) == sorted(jr.act_traces)
    assert len(tr.act_traces) == 4          # k and v sites of 2 layers
    for k, v in jr.act_traces.items():
        np.testing.assert_allclose(tr.act_traces[k], v, rtol=1e-4, err_msg=k)
    assert sorted(tr.act_ranges) == sorted(jr.act_ranges)
    for k, v in jr.act_ranges.items():
        # the same activations up to fp32 summation order
        np.testing.assert_allclose(tr.act_ranges[k], v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("avg_bits", [4.5, 6.0, 7.5])
def test_allocations_identical_given_reference_numbers(reports, avg_bits):
    jcfg, tcfg, jr, _ = reports
    tr = SensitivityReport.from_json(jr.to_json())
    jpol, tpol = JPolicy(allowed_bits=(8, 4)), TPolicy(allowed_bits=(8, 4))
    tb, jb = t_bits_from(tr, tpol, avg_bits), j_bits_from(jr, jpol, avg_bits)
    assert (tb.weight_bits, tb.act_bits) == (jb.weight_bits, jb.act_bits)
    assert len(set(tb.weight_bits.values())) == 2 or avg_bits != 6.0
    total = sum(jr.param_sizes.values())
    tg = t_greedy(tr, TPolicy(), avg_bits * total)
    jg = j_greedy(jr, JPolicy(), avg_bits * total)
    assert (tg.weight_bits, tg.act_bits) == (jg.weight_bits, jg.act_bits)
    tokens = 4 * 32
    budget = avg_bits / 8.0 * 2 * 2 * tokens * jcfg.num_kv_heads * jcfg.head_dim
    assert t_kv_bits(tr, tcfg, TPolicy(), budget, tokens) == \
        j_kv_bits(jr, jcfg, JPolicy(), budget, tokens)
