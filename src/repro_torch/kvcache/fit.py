"""FIT-driven KV-cache bit allocation (port of ``repro.kvcache.fit``).

The KV cache is a persistent activation: its values are the
``attn/k`` / ``attn/v`` tap sites of the forward, so their FIT terms are
what ``build_report`` computes. ``kv_report_fns`` exposes only those
sites to ``build_report``; ``allocate_kv_bits`` spends an HBM budget on
per-layer KV widths through ``core.mpq.allocate_act_sites``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from repro_torch.configs import ModelConfig
from repro_torch.core.fit import SensitivityReport
from repro_torch.core.mpq import allocate_act_sites
from repro_torch.kvcache.paged import kv_layer_count, kv_sites_for_layer
from repro_torch.quant.policy import QuantPolicy


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
                     exact: bool = False) -> Dict[int, int]:
    """Per-layer KV bit widths under ``budget_bytes`` of KV HBM, charged
    at each level's realized page storage (``bytes_per_element``).
    ``tokens`` is the cache's token capacity; a layer's k and v share one
    width. (The reference's ``tp_shards`` waits for tensor parallelism.)"""
    from repro_torch.qtensor import bytes_per_element

    groups = [list(pair) for pair in kv_sites(cfg)]
    elems = 2 * tokens * cfg.num_kv_heads * cfg.head_dim
    levels = sorted({int(b) for b in policy.kv_allowed_bits})
    bits = allocate_act_sites(
        report, policy, budget_bits=budget_bytes * 8.0,
        site_groups=groups, group_sizes=[elems] * len(groups),
        levels=levels, exact=exact,
        cost_bits=[8.0 * bytes_per_element(b) for b in levels])
    return {i: b for i, b in enumerate(bits)}
