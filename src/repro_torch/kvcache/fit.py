"""FIT-driven KV-cache bit allocation (port of ``repro.kvcache.fit``).

The KV cache is a persistent activation: its values are the
``attn/k`` / ``attn/v`` tap sites of the forward, so their FIT terms are
what ``build_report`` computes. ``kv_report_fns`` exposes only those
sites to ``build_report``; ``allocate_kv_bits`` spends an HBM budget on
per-layer KV widths through ``core.mpq.allocate_act_sites``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.configs import ModelConfig
from repro_torch.core.fit import SensitivityReport
from repro_torch.core.mpq import allocate_act_sites
from repro_torch.kvcache.paged import kv_layer_count, kv_sites_for_layer
from repro_torch.quant.policy import BitConfig, QuantPolicy


def kv_sites(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """(k_site, v_site) tap paths per attention layer."""
    return [kv_sites_for_layer(cfg, i) for i in range(kv_layer_count(cfg))]


def _is_kv_site(name: str) -> bool:
    return name.endswith("/attn/k") or name.endswith("/attn/v")


def kv_report_fns(cfg: ModelConfig) -> Tuple[Callable, Callable, Callable]:
    """(tap_loss_fn, tap_shapes_fn, act_fn) for ``build_report`` limited
    to the KV activation sites. ``tap_shapes_fn`` returns
    {site: (shape, dtype)}."""
    from repro_torch.models.context import CollectContext, TapContext
    from repro_torch.models.transformer import loss_fn

    def tap_loss_fn(params, taps, batch):
        return loss_fn(params, batch, cfg, ctx=TapContext(taps))

    def act_fn(params, batch):
        ctx = CollectContext()
        loss_fn(params, batch, cfg, ctx=ctx)
        return {k: a for k, a in ctx.acts.items() if _is_kv_site(k)}

    def tap_shapes_fn(params, batch):
        return {k: (tuple(a.shape), a.dtype)
                for k, a in act_fn(params, batch).items()}

    return tap_loss_fn, tap_shapes_fn, act_fn


def allocate_kv_bits(report: SensitivityReport, cfg: ModelConfig,
                     policy: QuantPolicy, budget_bytes: float, tokens: int,
                     exact: bool = False, tp_shards: int = 1) -> Dict[int, int]:
    """Per-layer KV bit widths under ``budget_bytes`` of KV HBM, charged
    at each level's realized page storage (``bytes_per_element``).
    ``tokens`` is the cache's token capacity; a layer's k and v share one
    width.

    ``tp_shards`` > 1 (tensor-parallel serving with kv-head-sharded
    pools) makes ``budget_bytes`` mean ONE shard's HBM: each shard
    stores 1/tp of every pool, so the spend is charged at the per-shard
    element count. Requires ``num_kv_heads % tp_shards == 0`` (a
    non-dividing mesh leaves the pools replicated: allocate with 1)."""
    from repro_torch.qtensor import bytes_per_element

    if tp_shards < 1:
        raise ValueError(f"tp_shards must be >= 1 (got {tp_shards})")
    if cfg.num_kv_heads % tp_shards:
        raise ValueError(
            f"tp_shards={tp_shards} does not divide num_kv_heads "
            f"({cfg.num_kv_heads}): the pool would stay replicated — "
            "budget per-shard accounting needs kv-head sharding")
    groups = [list(pair) for pair in kv_sites(cfg)]
    elems = 2 * tokens * cfg.num_kv_heads * cfg.head_dim
    levels = sorted({int(b) for b in policy.kv_allowed_bits})
    bits = allocate_act_sites(
        report, policy, budget_bits=budget_bytes * 8.0,
        site_groups=groups, group_sizes=[elems] * len(groups),
        levels=levels, exact=exact,
        cost_bits=[8.0 * bytes_per_element(b) for b in levels],
        shard_fraction=1.0 / tp_shards)
    return {i: b for i, b in enumerate(bits)}


def kv_bit_config(bits_by_layer: Mapping[int, int], cfg: ModelConfig,
                  policy: Optional[QuantPolicy] = None) -> BitConfig:
    """Per-layer bits -> policy-sanitized BitConfig on the KV act sites."""
    policy = policy or QuantPolicy()
    ab = {}
    for i, (ks, vs) in enumerate(kv_sites(cfg)):
        b = int(bits_by_layer.get(i, bits_by_layer.get(str(i), 16)))
        ab[ks] = b
        ab[vs] = b
    return policy.sanitize(BitConfig({}, ab))


def kv_bits_from_config(bit_cfg: BitConfig, cfg: ModelConfig
                        ) -> Dict[int, int]:
    """Inverse of ``kv_bit_config``: per-layer KV bits out of a
    BitConfig's act_bits (a layer's k/v widths unified with max, the
    conservative storage choice)."""
    out: Dict[int, int] = {}
    for i, (ks, vs) in enumerate(kv_sites(cfg)):
        b = max(bit_cfg.act_bits.get(ks, 16), bit_cfg.act_bits.get(vs, 16))
        out[i] = int(b)
    return out
