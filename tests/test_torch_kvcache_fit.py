"""The port's tensor-parallel-aware KV-cache helpers against
``repro.kvcache`` on the three smoke configs: ``allocate_kv_bits`` with
``tp_shards`` (per-shard budgets), ``per_shard_pool_bytes``,
``kv_bit_config`` / ``kv_bits_from_config``, and the refusal of a
``tp_shards`` that does not divide the kv heads."""
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core.fit import SensitivityReport as JReport
from repro.kvcache import (allocate_kv_bits as j_alloc, kv_bit_config as j_kvcfg,
                           kv_bits_from_config as j_kvback, kv_sites as j_sites)
from repro.kvcache.paged import (PagedKVConfig as JPagedKVConfig,
                                 per_shard_pool_bytes as j_shard_bytes)
from repro.quant.policy import QuantPolicy as JPolicy
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.fit import SensitivityReport as TReport
from repro_torch.kvcache import (PagedKVConfig, allocate_kv_bits, kv_bit_config,
                                 kv_bits_from_config, kv_sites,
                                 per_shard_pool_bytes)
from repro_torch.quant.policy import QuantPolicy
from repro_torch.serve import kv_bit_config as serve_kv_bit_config

ARCHS = ["internlm2_1_8b", "olmoe_1b_7b", "deepseek_moe_16b"]
SLOTS, MAX_LEN, PAGE = 4, 64, 16
POLICY = dict(kv_allowed_bits=(3, 4, 8, 16))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op CPU thread for this file's tests: the suite runs files
    in parallel worker processes, and several multi-threaded torch pools
    on one host stall each other (a speculative engine run here took
    ~50x its one-process time under six workers at the default)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reports(arch):
    """One random KV-site report, as the reference's and as the port's."""
    rng = np.random.default_rng(7)
    sites = [s for pair in kv_sites(t_smoke(arch)) for s in pair]
    assert sites == [s for pair in j_sites(j_smoke(arch)) for s in pair]
    d = dict(weight_traces={}, weight_ranges={}, param_sizes={},
             act_traces={s: float(rng.uniform(1e-3, 5.0)) for s in sites},
             act_ranges={s: (float(-rng.uniform(1, 4)), float(rng.uniform(1, 4)))
                         for s in sites})
    return JReport(**d), TReport(**d)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_aware_widths_and_bytes_match_reference(arch, tp):
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    jr, tr = _reports(arch)
    tokens = SLOTS * MAX_LEN
    dense8 = 2 * tokens * tcfg.num_kv_heads * tcfg.head_dim * tcfg.num_layers
    seen = set()
    # one per-device budget at every tp (3-bit pages cost 0.5 of int8):
    # a kv-sharded pool affords richer widths on more shards
    for frac in (0.55, 0.7, 0.9):
        args = (frac * dense8, tokens)
        if tcfg.num_kv_heads % tp:
            with pytest.raises(ValueError) as want:
                j_alloc(jr, jcfg, JPolicy(**POLICY), *args, tp_shards=tp)
            with pytest.raises(ValueError) as got:
                allocate_kv_bits(tr, tcfg, QuantPolicy(**POLICY), *args,
                                 tp_shards=tp)
            assert str(got.value) == str(want.value)
            assert "does not divide num_kv_heads" in str(got.value)
            bits = {i: 8 for i in range(tcfg.num_layers)}
        else:
            for exact in (False, True):
                want = j_alloc(jr, jcfg, JPolicy(**POLICY), *args, exact=exact,
                               tp_shards=tp)
                bits = allocate_kv_bits(tr, tcfg, QuantPolicy(**POLICY), *args,
                                        exact=exact, tp_shards=tp)
                assert bits == want
            seen.add(tuple(bits.values()))
        jp = JPagedKVConfig.build(jcfg, MAX_LEN, SLOTS, page_size=PAGE,
                                  kv_bits=bits)
        tpc = PagedKVConfig.build(tcfg, MAX_LEN, SLOTS, page_size=PAGE,
                                  kv_bits=bits)
        assert per_shard_pool_bytes(tcfg, tpc, tp) == j_shard_bytes(jcfg, jp, tp)
        bc = kv_bit_config(bits, tcfg)
        jbc = j_kvcfg(bits, jcfg)
        assert bc.act_bits == dict(jbc.act_bits) and bc.weight_bits == {}
        assert kv_bits_from_config(bc, tcfg) == j_kvback(jbc, jcfg)
        assert serve_kv_bit_config is kv_bit_config
    # (at tp=4 every budget affords 16 bits on every layer)
    assert tcfg.num_kv_heads % tp or len(seen) > 1 or seen == {
        (16,) * tcfg.num_layers}


def test_tp_shards_must_be_positive():
    jr, tr = _reports("olmoe_1b_7b")
    for side, rep, cfg, pol in ((j_alloc, jr, j_smoke("olmoe_1b_7b"), JPolicy()),
                                (allocate_kv_bits, tr, t_smoke("olmoe_1b_7b"),
                                 QuantPolicy())):
        with pytest.raises(ValueError, match="tp_shards must be >= 1"):
            side(rep, cfg, pol, 1e6, 64, tp_shards=0)
