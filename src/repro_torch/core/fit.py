"""FIT metric assembly (copy of ``repro.core.fit``; paper Sec. 3.2 / App. E).

    FIT(b) = Σ_l Tr(Î(θ_l)) · [ (θmax−θmin)/(2^{b_l}−1) ]² / 12
           + Σ_s Tr(Î(â_s)) · [ (âmax−âmin)/(2^{b_s}−1) ]² / 12

The constant 1/12 is shared by every term, so (as in the paper's Sec. 4.2
form) it can be dropped without changing rankings; we keep it so FIT is
literally the expected KL divergence scale E[δθᵀ I δθ]/2 ≈ FIT/2.

A ``SensitivityReport`` bundles traces + ranges once; evaluating a bit
configuration is then O(#blocks). For the paper's evaluation protocol —
scoring hundreds to thousands of MPQ configurations — even that Python
loop dominates, so ``PackedReport`` freezes the block ordering and
precomputes a ``(n_blocks, n_levels)`` table of per-block contributions
``trace × noise_power(range, bits)``. A batch of configs encoded as an
int level-index matrix is then scored with one gather + row-sum
(``fit_batch``), which is what the samplers/allocators in
``repro.core.mpq`` and the Table-2 benchmark run on.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping, Optional, Sequence, Tuple

import logging

import numpy as np

from repro_torch.quant.noise import noise_power
from repro_torch.quant.policy import BitConfig

log = logging.getLogger("repro_torch.fit")


@dataclasses.dataclass(frozen=True)
class PackedReport:
    """Array-backed view of a SensitivityReport at a frozen level set.

    ``weight_table[b, j]`` / ``act_table[s, j]`` hold the FIT contribution
    of block ``b`` / site ``s`` quantized to ``levels[j]`` bits (0 at
    >= 16 bits). Configurations are int matrices of level *indices*;
    scoring a batch is a single fancy-index gather plus a row sum — no
    per-config dict traversal.
    """

    weight_names: Tuple[str, ...]
    act_names: Tuple[str, ...]
    levels: Tuple[int, ...]              # ascending, always contains 16
    weight_table: np.ndarray             # (n_weight_blocks, n_levels) f64
    act_table: np.ndarray                # (n_act_sites, n_levels) f64
    weight_sizes: np.ndarray             # (n_weight_blocks,) i64

    def __post_init__(self):
        object.__setattr__(self, "_index", {b: j for j, b in enumerate(self.levels)})
        object.__setattr__(self, "_bits", np.asarray(self.levels, np.int64))

    # ---- construction ----
    @classmethod
    def from_report(
        cls,
        report: "SensitivityReport",
        levels: Sequence[int],
        w_sens: Optional[Mapping[str, float]] = None,
        a_sens: Optional[Mapping[str, float]] = None,
    ) -> "PackedReport":
        """Pack ``report`` at the given bit levels.

        ``w_sens``/``a_sens`` override the left-hand sensitivity factor
        (default: the EF traces) so the baseline heuristics (QR, Noise,
        BN — see ``repro.core.heuristics``) reuse the same batch engine.
        Activation sites with no calibrated range are skipped with a
        warning instead of raising (``build_report(act_fn=None, ...)``
        legitimately produces traces without ranges).
        """
        lv = tuple(sorted({int(b) for b in levels} | {16}))
        wnames = tuple(report.weight_traces)
        anames, skipped = [], []
        for name in report.act_traces:
            (anames if name in report.act_ranges else skipped).append(name)
        if skipped:
            log.warning(
                "packing: skipping %d activation site(s) without calibrated "
                "ranges (run build_report with act_fn to score them): %s",
                len(skipped), ", ".join(sorted(skipped)[:8]))
        anames = tuple(anames)

        def table(names, traces, ranges, sens):
            out = np.zeros((len(names), len(lv)), np.float64)
            for i, name in enumerate(names):
                s = traces[name] if sens is None else sens.get(name, 0.0)
                lo, hi = ranges[name]
                for j, bits in enumerate(lv):
                    if bits < 16:
                        out[i, j] = s * float(noise_power(lo, hi, bits))
            return out

        return cls(
            weight_names=wnames,
            act_names=anames,
            levels=lv,
            weight_table=table(wnames, report.weight_traces,
                               report.weight_ranges, w_sens),
            act_table=table(anames, report.act_traces, report.act_ranges,
                            a_sens),
            weight_sizes=np.array([report.param_sizes[k] for k in wnames],
                                  np.int64),
        )

    # ---- shape helpers ----
    @property
    def n_weight_blocks(self) -> int:
        return len(self.weight_names)

    @property
    def n_act_sites(self) -> int:
        return len(self.act_names)

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def level_index(self, bits: int) -> int:
        """Index of a bit width in the level set (>= 16 folds onto 16)."""
        return self._index[16 if bits >= 16 else int(bits)]

    # ---- the hot path ----
    def fit_batch(self, w_idx: np.ndarray,
                  a_idx: Optional[np.ndarray] = None) -> np.ndarray:
        """Score a batch of configs: (N, n_blocks) level indices -> (N,)."""
        return self.fit_weights_batch(w_idx) + (
            0.0 if a_idx is None else self.fit_acts_batch(a_idx))

    def fit_weights_batch(self, w_idx: np.ndarray) -> np.ndarray:
        w_idx = np.asarray(w_idx)
        rows = np.arange(self.n_weight_blocks)
        return self.weight_table[rows, w_idx].sum(axis=-1)

    def fit_acts_batch(self, a_idx: np.ndarray) -> np.ndarray:
        a_idx = np.asarray(a_idx)
        rows = np.arange(self.n_act_sites)
        return self.act_table[rows, a_idx].sum(axis=-1)

    def cost_bits_batch(self, w_idx: np.ndarray) -> np.ndarray:
        """Weight storage cost in bits per config: (N, n_blocks) -> (N,)."""
        return (self._bits[np.asarray(w_idx)]
                * self.weight_sizes).sum(axis=-1).astype(np.float64)

    # ---- BitConfig interop ----
    def encode(self, configs: Sequence[BitConfig]) -> Tuple[np.ndarray, np.ndarray]:
        """BitConfigs -> (W, A) level-index matrices (missing blocks = 16)."""
        W = np.empty((len(configs), self.n_weight_blocks), np.int64)
        A = np.empty((len(configs), self.n_act_sites), np.int64)
        for i, cfg in enumerate(configs):
            for j, name in enumerate(self.weight_names):
                W[i, j] = self.level_index(cfg.weight_bits.get(name, 16))
            for j, name in enumerate(self.act_names):
                A[i, j] = self.level_index(cfg.act_bits.get(name, 16))
        return W, A

    def decode(self, w_row: np.ndarray,
               a_row: Optional[np.ndarray] = None) -> BitConfig:
        wb = {name: int(self.levels[int(w_row[j])])
              for j, name in enumerate(self.weight_names)}
        ab = {}
        if a_row is not None:
            ab = {name: int(self.levels[int(a_row[j])])
                  for j, name in enumerate(self.act_names)}
        return BitConfig(wb, ab)


@dataclasses.dataclass
class SensitivityReport:
    """Everything FIT needs, computed once from the trained FP model."""

    weight_traces: Dict[str, float]              # block -> Tr(Î(θ_l))
    act_traces: Dict[str, float]                 # site  -> Tr(Î(â_s))
    weight_ranges: Dict[str, Tuple[float, float]]  # block -> (min, max)
    act_ranges: Dict[str, Tuple[float, float]]     # site  -> (min, max)
    param_sizes: Dict[str, int]                  # block -> n(l)

    def __post_init__(self):
        self._packed_cache: Dict[Tuple[int, ...], PackedReport] = {}
        self._warned_missing_act_ranges = False

    def packed(self, levels: Sequence[int]) -> PackedReport:
        """Array-backed view at a level set (cached per level tuple)."""
        key = tuple(sorted({int(b) for b in levels} | {16}))
        if key not in self._packed_cache:
            self._packed_cache[key] = PackedReport.from_report(self, key)
        return self._packed_cache[key]

    def fit_weights(self, weight_bits: Mapping[str, int]) -> float:
        total = 0.0
        for name, tr in self.weight_traces.items():
            bits = weight_bits.get(name, 16)
            if bits >= 16:
                continue
            lo, hi = self.weight_ranges[name]
            total += tr * float(noise_power(lo, hi, bits))
        return total

    def fit_acts(self, act_bits: Mapping[str, int]) -> float:
        total = 0.0
        warned = []
        for name, tr in self.act_traces.items():
            bits = act_bits.get(name, 16)
            if bits >= 16:
                continue
            rng = self.act_ranges.get(name)
            if rng is None:
                warned.append(name)
                continue
            lo, hi = rng
            total += tr * float(noise_power(lo, hi, bits))
        if warned and not self._warned_missing_act_ranges:
            # once per report: scoring thousands of configs through this
            # path must not emit one log line per config
            self._warned_missing_act_ranges = True
            log.warning(
                "fit_acts: %d activation site(s) have traces but no "
                "calibrated range; treating as unquantized: %s",
                len(warned), ", ".join(sorted(warned)[:8]))
        return total

    def fit(self, cfg: BitConfig) -> float:
        """The full FIT metric: lower = less predicted degradation."""
        return self.fit_weights(cfg.weight_bits) + self.fit_acts(cfg.act_bits)

    # ---- serialization (reports are checkpoint artifacts) ----
    def to_json(self) -> str:
        return json.dumps({
            "weight_traces": self.weight_traces,
            "act_traces": self.act_traces,
            "weight_ranges": {k: list(v) for k, v in self.weight_ranges.items()},
            "act_ranges": {k: list(v) for k, v in self.act_ranges.items()},
            "param_sizes": self.param_sizes,
        })

    @classmethod
    def from_json(cls, s: str) -> "SensitivityReport":
        d = json.loads(s)
        return cls(
            weight_traces=d["weight_traces"],
            act_traces=d["act_traces"],
            weight_ranges={k: tuple(v) for k, v in d["weight_ranges"].items()},
            act_ranges={k: tuple(v) for k, v in d["act_ranges"].items()},
            param_sizes={k: int(v) for k, v in d["param_sizes"].items()},
        )


@dataclasses.dataclass(frozen=True)
class DraftPlan:
    """FIT-chosen draft widths for self-speculative decoding.

    ``kl_proxy`` is the draft config's FIT score: up to the metric's
    Fisher approximation, twice the expected KL between the fp model and
    the draft, the quantity that governs how often the draft's
    next-token distribution disagrees with the serving model's.
    ``accept_proxy = exp(-kl_proxy / 2)`` maps it onto (0, 1] as a
    monotone stand-in for the per-token accept rate: 1.0 when the draft
    is the serving config, decaying as the draft gets more aggressive.
    """

    bits: BitConfig
    kl_proxy: float
    accept_proxy: float
    avg_bits: float


def allocate_draft_bits(report: SensitivityReport, policy=None,
                        avg_bits: float = 3.0) -> DraftPlan:
    """Allocate a draft BitConfig under an accept-rate/KL proxy: the
    serving config's marginal-utility greedy (``core.mpq.greedy_allocate``)
    at an aggressive average-bits budget, scored with FIT. The draft
    shares the serving tree's storage format (QTensor re-packed at the
    draft widths), so this trades draft-step cost against the accept
    rate the FIT score predicts — no draft training, no second model."""
    from repro_torch.core.mpq import config_cost_bits, greedy_allocate
    from repro_torch.quant.policy import QuantPolicy
    policy = policy or QuantPolicy()
    total = sum(report.param_sizes.values())
    cfg = greedy_allocate(report, policy, budget_bits=avg_bits * total)
    bits = BitConfig(cfg.weight_bits, {})
    kl = float(report.fit_weights(bits.weight_bits))
    realized = config_cost_bits(report, bits) / max(total, 1)
    return DraftPlan(bits=bits, kl_proxy=kl,
                     accept_proxy=float(np.exp(-0.5 * kl)),
                     avg_bits=float(realized))
