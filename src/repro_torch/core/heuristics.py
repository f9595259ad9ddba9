"""Baseline sensitivity heuristics the paper compares FIT against (copy
of ``repro.core.heuristics``).

All share FIT's noise model [Δ_l]² = [(θmax−θmin)/(2^b−1)]² and differ in
the left-hand sensitivity factor (paper Appendix D):

  QR:    1/|θmax−θmin|      (quantization range; Chen 2021 / Tang 2022 style)
  BN:    1/γ_l              (batch-norm scale; only where BN exists)
  Noise: 1                  (isolated noise model, ablation)
  FIT_W / FIT_A: FIT with the activation / weight half removed.

HAWQ-V2 (Hessian-trace-weighted) is FIT_W with Hutchinson traces —
available via core.hessian.hutchinson_block_traces feeding the same
assembly, so it needs no separate formula here.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.quant.noise import noise_power
from repro_torch.quant.policy import BitConfig
from repro_torch.core.fit import PackedReport, SensitivityReport


def qr_metric(report: SensitivityReport, cfg: BitConfig,
              include_acts: bool = True, include_weights: bool = True) -> float:
    total = 0.0
    if include_weights:
        for name, (lo, hi) in report.weight_ranges.items():
            bits = cfg.weight_bits.get(name, 16)
            if bits >= 16 or hi - lo <= 0:
                continue
            total += float(noise_power(lo, hi, bits)) / (hi - lo)
    if include_acts:
        for name, (lo, hi) in report.act_ranges.items():
            bits = cfg.act_bits.get(name, 16)
            if bits >= 16 or hi - lo <= 0:
                continue
            total += float(noise_power(lo, hi, bits)) / (hi - lo)
    return total


def bn_metric(report: SensitivityReport, cfg: BitConfig,
              gammas: Mapping[str, float]) -> float:
    """γ-weighted noise. ``gammas`` maps weight block -> mean |γ| of its BN."""
    total = 0.0
    for name, (lo, hi) in report.weight_ranges.items():
        bits = cfg.weight_bits.get(name, 16)
        g = gammas.get(name)
        if bits >= 16 or g is None or g <= 0:
            continue
        total += float(noise_power(lo, hi, bits)) / g
    return total


def noise_metric(report: SensitivityReport, cfg: BitConfig) -> float:
    """Isolated quantization-noise model (no sensitivity weighting)."""
    total = 0.0
    for name, (lo, hi) in report.weight_ranges.items():
        bits = cfg.weight_bits.get(name, 16)
        if bits >= 16:
            continue
        total += float(noise_power(lo, hi, bits))
    for name, (lo, hi) in report.act_ranges.items():
        bits = cfg.act_bits.get(name, 16)
        if bits >= 16:
            continue
        total += float(noise_power(lo, hi, bits))
    return total


def fit_w(report: SensitivityReport, cfg: BitConfig) -> float:
    return report.fit_weights(cfg.weight_bits)


def fit_a(report: SensitivityReport, cfg: BitConfig) -> float:
    return report.fit_acts(cfg.act_bits)


ALL_METRICS = {
    "FIT": lambda r, c, **kw: r.fit(c),
    "FIT_W": lambda r, c, **kw: fit_w(r, c),
    "FIT_A": lambda r, c, **kw: fit_a(r, c),
    "QR": lambda r, c, **kw: qr_metric(r, c),
    "QR_W": lambda r, c, **kw: qr_metric(r, c, include_acts=False),
    "QR_A": lambda r, c, **kw: qr_metric(r, c, include_weights=False),
    "Noise": lambda r, c, **kw: noise_metric(r, c),
}


# ---- vectorized variants on the PackedReport engine -----------------------
#
# Every metric above is Σ_blocks sens(block) · noise_power(range, bits) with
# a different sensitivity factor, so each one packs into the same
# (n_blocks, n_levels) lookup tables and scores a batch of level-index
# configs with one gather + row-sum (Table-2 runs on this path).

def _qr_sens(ranges: Mapping[str, Tuple[float, float]]) -> Dict[str, float]:
    return {k: (1.0 / (hi - lo) if hi - lo > 0 else 0.0)
            for k, (lo, hi) in ranges.items()}


def metric_packed(
    report: SensitivityReport,
    metric: str,
    levels: Sequence[int],
    gammas: Optional[Mapping[str, float]] = None,
) -> PackedReport:
    """Pack any Table-2 metric for batch scoring via ``fit_batch``.

    The returned PackedReport's tables hold that metric's per-block
    contributions; zeroed halves (e.g. activations for FIT_W) make the
    shared gather a no-op for the excluded side.
    """
    ones_w = {k: 1.0 for k in report.weight_ranges}
    ones_a = {k: 1.0 for k in report.act_ranges}
    zero: Dict[str, float] = {}
    if metric == "FIT":
        return PackedReport.from_report(report, levels)
    if metric == "FIT_W":
        return PackedReport.from_report(report, levels, a_sens=zero)
    if metric == "FIT_A":
        return PackedReport.from_report(report, levels, w_sens=zero)
    if metric == "QR":
        return PackedReport.from_report(
            report, levels, w_sens=_qr_sens(report.weight_ranges),
            a_sens=_qr_sens(report.act_ranges))
    if metric == "QR_W":
        return PackedReport.from_report(
            report, levels, w_sens=_qr_sens(report.weight_ranges), a_sens=zero)
    if metric == "QR_A":
        return PackedReport.from_report(
            report, levels, w_sens=zero, a_sens=_qr_sens(report.act_ranges))
    if metric == "Noise":
        return PackedReport.from_report(report, levels, w_sens=ones_w,
                                        a_sens=ones_a)
    if metric == "BN":
        if gammas is None:
            raise ValueError("BN metric needs gammas")
        sens = {k: (1.0 / g if g > 0 else 0.0) for k, g in gammas.items()}
        return PackedReport.from_report(report, levels, w_sens=sens,
                                        a_sens=zero)
    raise KeyError(f"unknown metric {metric!r}")


def metric_values_batch(
    report: SensitivityReport,
    metric: str,
    levels: Sequence[int],
    W: np.ndarray,
    A: np.ndarray,
    gammas: Optional[Mapping[str, float]] = None,
) -> np.ndarray:
    """(N,) metric values for a batch of encoded configs."""
    return metric_packed(report, metric, levels, gammas).fit_batch(W, A)
