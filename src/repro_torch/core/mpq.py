"""Mixed-precision configuration search driven by FIT (copy of
``repro.core.mpq``).

The search space is O(|B|^{2L}) (Sec. 2); FIT collapses it to a scalar
score per configuration. Everything here runs on the array-backed
``PackedReport`` engine: configurations are int level-index matrices and
scoring a batch is one gather + row-sum (``PackedReport.fit_batch``) —
no per-config dict traversal anywhere on the hot path.

Three allocators, increasing in optimality:

  * ``pareto_front``  — sensitivity-vs-size front over sampled configs
                        (HAWQ-V2 style model selection).
  * ``greedy_allocate`` — start everything at the lowest bit width and
    repeatedly spend the budget on the block with the best
    ΔFIT / Δbits-cost ratio. Near-optimal because per-block FIT terms are
    independent, monotone and convex in bits.
  * ``dp_allocate``  — exact DP over (block, discretized budget); the
    knapsack analogue of HAWQ-V3's ILP, used to validate greedy.

Both budgeted allocators run on generic (contribution-table, sizes,
budget) cores — ``_greedy_spend`` / ``_dp_spend`` — so the same
machinery allocates WEIGHT bits (sizes = parameter counts) and
persistent-ACTIVATION bits: ``allocate_act_sites`` assigns per-site bit
widths to activation sites whose quantized values are *stored* (the
serving KV cache — ``repro.kvcache``) under an HBM budget.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.fit import PackedReport, SensitivityReport
from repro_torch.quant.policy import BitConfig, QuantPolicy


def _policy_packed(report: SensitivityReport,
                   policy: QuantPolicy) -> PackedReport:
    """Pack at the policy's level set (allowed bits + pinned bits + 16)."""
    return report.packed(tuple(policy.allowed_bits) + (policy.pinned_bits,))


def _pin_level(packed: PackedReport, policy: QuantPolicy) -> int:
    """Index of the smallest packed level >= pinned_bits (16 worst case)."""
    for j, bits in enumerate(packed.levels):
        if bits >= policy.pinned_bits:
            return j
    return packed.n_levels - 1


def config_cost_bits(report: SensitivityReport, cfg: BitConfig) -> float:
    """Weight storage cost in bits (activations don't count toward size)."""
    return sum(report.param_sizes[k] * cfg.weight_bits.get(k, 16)
               for k in report.param_sizes)


def sample_packed(
    report: SensitivityReport,
    policy: QuantPolicy,
    n: int,
    seed: int = 0,
) -> Tuple[PackedReport, np.ndarray, np.ndarray]:
    """Sample ``n`` policy-sanitized random configs directly in index space.

    Returns ``(packed, W, A)`` where W is (n, n_weight_blocks) and A is
    (n, n_act_sites) — ready for ``packed.fit_batch(W, A)``. This is the
    paper's Table-2 uniform sampling scheme, vectorized: two ``integers``
    draws instead of 2·n·L Python-level ``rng.choice`` calls.
    """
    packed = _policy_packed(report, policy)
    rng = np.random.default_rng(seed)
    allowed = np.array(sorted({int(b) for b in policy.allowed_bits}))
    allowed_idx = np.array([packed.level_index(b) for b in allowed])

    W = allowed_idx[rng.integers(0, len(allowed_idx),
                                 (n, packed.n_weight_blocks))]
    A = allowed_idx[rng.integers(0, len(allowed_idx),
                                 (n, packed.n_act_sites))]

    pin = _pin_level(packed, policy)
    W = policy.sanitize_indices(W, policy.pinned_mask(packed.weight_names), pin)
    A = policy.sanitize_indices(A, policy.pinned_mask(packed.act_names), pin)
    if not policy.quantize_activations:
        A[:] = packed.level_index(16)
    return packed, W, A


def sample_configs(
    report: SensitivityReport,
    policy: QuantPolicy,
    n: int,
    seed: int = 0,
) -> List[BitConfig]:
    """BitConfig-valued wrapper over ``sample_packed`` (compat API)."""
    packed, W, A = sample_packed(report, policy, n, seed)
    return [packed.decode(W[i], A[i]) for i in range(n)]


def pareto_front(
    report: SensitivityReport,
    configs: Sequence[BitConfig],
) -> List[Tuple[float, float, BitConfig]]:
    """(size_bits, fit, cfg) tuples on the sensitivity-size Pareto front."""
    if not configs:
        return []
    levels = {b for c in configs for b in c.weight_bits.values()}
    levels |= {b for c in configs for b in c.act_bits.values()}
    packed = report.packed(levels)
    W, A = packed.encode(configs)

    sizes = packed.cost_bits_batch(W)
    fits = packed.fit_batch(W, A)
    order = np.lexsort((fits, sizes))
    ff = fits[order]
    # keep strictly-improving fits in size order (vectorized running min)
    prev_best = np.concatenate(([np.inf], np.minimum.accumulate(ff)[:-1]))
    keep = ff < prev_best
    return [(float(sizes[i]), float(fits[i]), configs[i])
            for i in order[keep]]


def _greedy_spend(tbl: np.ndarray, sizes: np.ndarray, bits_arr: np.ndarray,
                  start: np.ndarray, used: float,
                  budget_bits: float) -> np.ndarray:
    """Marginal-utility greedy over a contribution table.

    ``tbl`` is (n, n_levels) FIT contributions at ascending bit levels,
    ``sizes`` the per-row stored-element counts, ``start`` per-row level
    floors, ``used`` the bits already charged at the floors. Because the
    per-row terms are convex in bits, per-row upgrade ratios are
    non-increasing, so one global stable argsort over all (row, rung)
    moves visits each row's rungs in order — the classic lazy-heap
    greedy with the gain/cost tables precomputed as arrays. Returns the
    chosen level index per row.
    """
    n_l = tbl.shape[1]
    gains = tbl[:, :-1] - tbl[:, 1:]                       # rung p -> p+1
    costs = sizes[:, None] * (bits_arr[1:] - bits_arr[:-1])[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        # zero-cost rungs (two levels sharing one storage container, e.g.
        # packed 3- and 4-bit nibbles under cost_bits) are a free lunch:
        # rank them first and never charge them against the budget
        ratio = np.where(costs > 0, gains / costs,
                         np.where(gains > 0, np.inf, -np.inf))
    valid = np.arange(n_l - 1)[None, :] >= start[:, None]
    cur = start.copy()
    flat = np.argsort(-ratio, axis=None, kind="stable")
    bs, ps = np.unravel_index(flat, ratio.shape)
    for b, p in zip(bs, ps):
        if not valid[b, p] or cur[b] != p:
            continue       # below this row's floor, or a cheaper rung
        c = costs[b, p]    # was skipped for budget — row is frozen
        if c > 0 and used + c > budget_bits:
            continue
        if c <= 0 and gains[b, p] <= 0:
            continue       # free but useless — leave the row alone
        cur[b] = p + 1
        used += max(c, 0.0)
    return cur


def _dp_spend(terms: np.ndarray, bits_opts: np.ndarray, valid: np.ndarray,
              sizes: np.ndarray, budget_bits: float,
              resolution: int) -> np.ndarray:
    """Exact knapsack DP over a contribution table (budget discretized
    into ``resolution`` buckets). ``terms``/``bits_opts``/``valid`` are
    (n, n_opt) per-row option arrays. Returns the chosen option per row.

    The per-row relaxation sweep is vectorized over the bucket axis:
    each (row, option) pair is one shifted elementwise min over the
    bucket array instead of a Python loop per bucket.
    """
    n = terms.shape[0]
    unit = max(budget_bits / resolution, 1.0)
    n_buckets = resolution + 1
    INF = float("inf")
    best = np.full(n_buckets, INF)
    best[0] = 0.0
    choice = np.full((n, n_buckets), -1, dtype=np.int64)
    for bi in range(n):
        new_best = np.full(n_buckets, INF)
        new_choice = np.full(n_buckets, -1, dtype=np.int64)
        for oi in range(terms.shape[1]):
            if not valid[bi, oi]:
                continue
            # round-to-nearest buckets: ceil would make exact-budget
            # configs infeasible; worst-case overshoot is n·unit/2,
            # i.e. ≤ 0.1% of budget at resolution 512.
            cb = int(round(sizes[bi] * bits_opts[bi, oi] / unit))
            if cb >= n_buckets:
                continue
            span = n_buckets - cb
            cand = best[:span] + terms[bi, oi]
            upd = cand < new_best[cb:]
            new_best[cb:][upd] = cand[upd]
            new_choice[cb:][upd] = oi * n_buckets + np.nonzero(upd)[0]
        best, choice[bi] = new_best, new_choice

    finite = np.where(best < INF)[0]
    if len(finite) == 0:
        raise ValueError("budget too small for the mandatory options")
    cursor = int(finite[np.argmin(best[finite])])

    out = np.empty(n, np.int64)
    for bi in range(n - 1, -1, -1):
        packed = int(choice[bi][cursor])
        out[bi], cursor = packed // n_buckets, packed % n_buckets
    return out


def allocate_act_sites(
    report: SensitivityReport,
    policy: QuantPolicy,
    budget_bits: float,
    site_groups: Sequence[Sequence[str]],
    group_sizes: Sequence[float],
    levels: Optional[Sequence[int]] = None,
    exact: bool = False,
    cost_bits: Optional[Sequence[float]] = None,
    shard_fraction: float = 1.0,
) -> List[int]:
    """Bit allocation for STORED activation state under a size budget.

    The serving KV cache is a persistent activation (PAPER.md §3: weight
    and activation sensitivities fuse into one metric), so its per-layer
    bit widths come from the same FIT tables as weight MPQ — only the
    cost model changes: a site's storage is ``group_sizes`` elements
    (e.g. KV capacity · heads · head_dim), not a parameter count.

    ``site_groups`` are activation-site name groups that must share one
    bit width (a layer's k and v caches — one storage dtype per layer);
    each group's FIT contribution is the sum of its sites' table rows.
    Returns bits per group (greedy by default, exact DP with ``exact``).

    ``cost_bits`` (parallel to the sorted ``levels``) prices each level's
    REALIZED storage in bits/element when that differs from the nominal
    grid width — e.g. packed 3-bit rides a 4-bit nibble container, and
    7/5-bit are grid-reduced int8 bytes (``repro.qtensor``). The FIT
    benefit table still uses the nominal widths (the noise model is the
    grid's); only the budget spend changes. Defaults to the nominal
    widths.

    ``shard_fraction`` makes the budget PER-SHARD-aware for
    tensor-parallel serving: a pool sharded across tp devices stores
    only ``1/tp`` of each site's elements per shard, so the spend is
    charged at ``group_sizes * shard_fraction`` against a budget that
    now means ONE shard's HBM. With the default 1.0 (replicated pool)
    nothing changes.
    """
    if not (0.0 < shard_fraction <= 1.0):
        raise ValueError(
            f"shard_fraction must be in (0, 1] (got {shard_fraction}); "
            "pass 1/tp for a pool sharded across tp devices")
    levels = sorted({int(b) for b in (levels or policy.kv_allowed_bits)})
    # static sanity before the greedy/DP cores: non-finite sizes/budgets
    # used to surface as silent NaN spend, and a level outside the
    # storage container would allocate an unstorable width (RPR2xx)
    from repro_torch.analysis.bounds import require_act_alloc_sane
    require_act_alloc_sane(budget_bits, group_sizes, levels)
    if cost_bits is not None and len(cost_bits) != len(levels):
        raise ValueError(f"cost_bits {cost_bits} must map 1:1 onto the "
                         f"sorted level set {levels}")
    packed = report.packed(levels)
    row_of = {n: i for i, n in enumerate(packed.act_names)}
    aidx = [packed.level_index(b) for b in levels]
    tbl = np.zeros((len(site_groups), len(levels)), np.float64)
    for gi, group in enumerate(site_groups):
        for site in group:
            if site not in row_of:
                raise KeyError(
                    f"activation site {site!r} has no trace+range in the "
                    "report — build_report needs tap_loss_fn/act_fn "
                    "covering the KV sites (see repro.kvcache.fit)")
            tbl[gi] += packed.act_table[row_of[site], aidx]
    sizes = np.asarray(group_sizes, np.float64) * float(shard_fraction)
    bits_arr = np.asarray(cost_bits if cost_bits is not None else levels,
                          np.float64)
    if np.any(np.diff(bits_arr) < 0):
        raise ValueError(f"cost_bits {bits_arr} must be non-decreasing in "
                         "the level order (higher grid, >= storage)")
    if exact:
        n_opt = len(levels)
        cur = _dp_spend(tbl, np.broadcast_to(bits_arr, tbl.shape),
                        np.ones((len(site_groups), n_opt), bool), sizes,
                        budget_bits, resolution=512)
    else:
        used = float((sizes * bits_arr[0]).sum())
        if used > budget_bits:
            raise ValueError(
                f"budget {budget_bits:.3g} bits cannot hold the KV cache "
                f"even at {levels[0]} bits ({used:.3g} bits)")
        cur = _greedy_spend(tbl, sizes, bits_arr,
                            np.zeros(len(site_groups), np.int64), used,
                            budget_bits)
    return [levels[int(c)] for c in cur]


def greedy_allocate(
    report: SensitivityReport,
    policy: QuantPolicy,
    budget_bits: float,
    act_bits_fixed: Optional[int] = None,
) -> BitConfig:
    """Marginal-utility greedy bit allocation under a weight-size budget.

    Every weight block starts at min(allowed_bits) (pinned blocks at the
    smallest allowed level >= pinned_bits); upgrades are applied
    best-(ΔFIT per bit·param)-first while the budget allows. Because the
    per-block FIT terms are convex in bits, per-block upgrade ratios are
    non-increasing, so a single global argsort over all (block, rung)
    moves visits each block's rungs in order — equivalent to the classic
    lazy-heap greedy, with the gain/cost tables precomputed as arrays.
    Activation sites get ``act_bits_fixed`` (default: policy default)
    since they do not consume storage budget.
    """
    levels = sorted({int(b) for b in policy.allowed_bits})
    packed = report.packed(levels)
    aidx = np.array([packed.level_index(b) for b in levels])
    bits_arr = np.array(levels, np.float64)
    n_b, n_l = packed.n_weight_blocks, len(levels)

    pinned = policy.pinned_mask(packed.weight_names)
    start = np.zeros(n_b, np.int64)
    if pinned.any():
        # smallest allowed level >= pinned_bits (max allowed as fallback;
        # sanitize() re-raises to pinned_bits if no allowed level reaches it)
        p = int(np.searchsorted(bits_arr, policy.pinned_bits))
        start[pinned] = min(p, n_l - 1)

    sizes = packed.weight_sizes.astype(np.float64)
    tbl = packed.weight_table[:, aidx]                     # (n_b, n_l)
    # charge pinned blocks at >= pinned_bits even when no allowed level
    # reaches it (sanitize() will raise their bits after allocation, so
    # budgeting them lower would let the result overshoot the budget)
    eff_bits = bits_arr[start].copy()
    eff_bits[pinned] = np.maximum(eff_bits[pinned], policy.pinned_bits)
    used = float((sizes * eff_bits).sum())
    cur = _greedy_spend(tbl, sizes, bits_arr, start, used, budget_bits)

    wb = {name: levels[cur[j]] for j, name in enumerate(packed.weight_names)}
    ab = act_bits_fixed if act_bits_fixed is not None else policy.default_act_bits
    cfg = BitConfig(wb, {k: ab for k in report.act_traces})
    return policy.sanitize(cfg)


def dp_allocate(
    report: SensitivityReport,
    policy: QuantPolicy,
    budget_bits: float,
    act_bits_fixed: Optional[int] = None,
    resolution: int = 256,
) -> BitConfig:
    """Exact knapsack DP (budget discretized into ``resolution`` buckets).

    The per-block relaxation sweep is vectorized over the bucket axis:
    each (block, option) pair is one shifted elementwise min over the
    bucket array instead of a Python loop per bucket.
    """
    packed = _policy_packed(report, policy)
    blocks = list(packed.weight_names)
    levels = sorted({int(b) for b in policy.allowed_bits})
    sizes = packed.weight_sizes.astype(np.float64)
    pinned = policy.pinned_mask(packed.weight_names)

    n, n_opt = len(blocks), len(levels)
    bits_opts = np.broadcast_to(np.array(levels, np.float64),
                                (n, n_opt)).copy()
    valid = np.ones((n, n_opt), bool)
    bits_opts[pinned, 0] = policy.pinned_bits    # pinned: single option
    valid[pinned, 1:] = False
    terms = np.empty((n, n_opt), np.float64)
    for oi in range(n_opt):
        terms[:, oi] = packed.weight_table[
            np.arange(n), [packed.level_index(int(b)) for b in bits_opts[:, oi]]]

    try:
        opt_idx = _dp_spend(terms, bits_opts, valid, sizes, budget_bits,
                            resolution)
    except ValueError:
        raise ValueError("budget too small for pinned blocks")
    bits_out = {name: int(bits_opts[bi, opt_idx[bi]])
                for bi, name in enumerate(blocks)}

    ab = act_bits_fixed if act_bits_fixed is not None else policy.default_act_bits
    return policy.sanitize(BitConfig(bits_out, {k: ab for k in report.act_traces}))
