"""Rank-correlation evaluation protocol (paper contribution #3; copy of
``repro.core.rankcorr``).

Previous MPQ works validate on a handful of configurations; the paper's
protocol trains hundreds of random configurations and reports the rank
correlation between metric and final accuracy. Lower FIT should mean
higher accuracy, so a *good* metric has strongly negative Spearman rho
against accuracy; we report |rho| ("correlation strength") to match the
paper's tables.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average-tie ranking (1-based), scipy-free for portability."""
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x), dtype=np.float64)
    sx = x[order]
    i = 0
    while i < len(x):
        j = i
        while j + 1 < len(x) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def pearson(x: Sequence[float], y: Sequence[float]) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xc, yc = x - x.mean(), y - y.mean()
    denom = np.sqrt((xc * xc).sum() * (yc * yc).sum())
    if denom == 0:
        return 0.0
    return float((xc * yc).sum() / denom)


def spearman(x: Sequence[float], y: Sequence[float]) -> float:
    return pearson(_rankdata(np.asarray(x, np.float64)),
                   _rankdata(np.asarray(y, np.float64)))


def kendall(x: Sequence[float], y: Sequence[float]) -> float:
    """O(n²) Kendall tau-a (fine for the config counts used here)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = len(x)
    s = 0
    for i in range(n):
        s += np.sum(np.sign(x[i] - x[i + 1:]) * np.sign(y[i] - y[i + 1:]))
    return float(2.0 * s / (n * (n - 1))) if n > 1 else 0.0


def metric_accuracy_correlation(
    metric_values: Sequence[float],
    accuracies: Sequence[float],
) -> Dict[str, float]:
    """Correlation strength of a sensitivity metric against final accuracy.

    Sign convention: metrics predict *degradation*, so perfect behaviour is
    rho = −1 vs accuracy; we report the negated value (higher = better,
    matching the paper's tables where FIT scores ≈ 0.9).
    """
    rho = spearman(metric_values, accuracies)
    r = pearson(metric_values, accuracies)
    tau = kendall(metric_values, accuracies)
    return {"spearman": -rho, "pearson": -r, "kendall": -tau}
