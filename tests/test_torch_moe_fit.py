"""The port's FIT report on the MoE smoke configs (olmoe_1b_7b,
deepseek_moe_16b) against repro.core: per-sample EF traces of every
block (3-D expert stacks reach ef_sqnorm as (mb, E·K·N) rows; the router
stays an fp32 block), the KV activation traces, and the W4/W8
allocation each side derives from its own report."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import build_report as j_build
from repro.data.synthetic import LMStreamConfig, lm_batches
from repro.kvcache.fit import kv_report_fns as j_kv_fns
from repro.models.transformer import loss_fn as j_loss
from repro.quant.policy import QuantPolicy as JPolicy
from repro.serve.quantized import bit_config_from_report as j_bits_from
from repro_torch.core.report import build_report as t_build
from repro_torch.kvcache.fit import kv_report_fns as t_kv_fns
from repro_torch.models.transformer import loss_fn as t_loss
from repro_torch.quant.policy import QuantPolicy as TPolicy
from repro_torch.serve.quantized import bit_config_from_report as t_bits_from
from test_torch_moe import ARCHS, make_models


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return make_models(request.param)


def test_ef_traces_and_allocation_match(model):
    jcfg, jp, tcfg, tp = model
    stream = lm_batches(LMStreamConfig(vocab_size=jcfg.vocab_size, seq_len=12,
                                       global_batch=4, seed=0))
    batches = [next(stream)]
    jtl, jts, jaf = j_kv_fns(jcfg)
    jr = j_build(lambda p, b: j_loss(p, b, jcfg), jtl, lambda b: jts(jp, b),
                 jaf, jp, [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
                 microbatch=2, tolerance=None, max_batches=1)
    ttl, tts, taf = t_kv_fns(tcfg)
    tr = t_build(lambda p, b: t_loss(p, b, tcfg), ttl, lambda b: tts(tp, b),
                 taf, tp, batches, microbatch=2, tolerance=None, max_batches=1,
                 device="cpu")
    assert sorted(tr.act_traces) == sorted(jr.act_traces)
    assert len(tr.act_traces) == 2 * tcfg.num_layers     # the KV sites
    assert list(tr.weight_traces) == list(jr.weight_traces)
    assert "layers/0/moe/router" in tr.weight_traces
    for k, v in jr.weight_traces.items():
        np.testing.assert_allclose(tr.weight_traces[k], v, rtol=1e-4, err_msg=k)
    for k, v in jr.act_traces.items():
        np.testing.assert_allclose(tr.act_traces[k], v, rtol=1e-4, err_msg=k)
    assert tr.param_sizes == jr.param_sizes
    tb = t_bits_from(tr, TPolicy(allowed_bits=(8, 4)), 6.0)
    jb = j_bits_from(jr, JPolicy(allowed_bits=(8, 4)), 6.0)
    assert tb.weight_bits == jb.weight_bits
    assert set(tb.weight_bits.values()) == {4, 8}
    assert tb.weight_bits["layers/0/moe/router"] >= 8         # pinned
