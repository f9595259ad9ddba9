"""Bench trajectory files + the noise-aware regression gate (port of
``repro.obs.perf.history``: the same schema, so each package reads the
other's files).

A trajectory file (``BENCH_<name>.json``) is a schema-versioned append
log of bench runs: each run carries a flat ``{metric: float}`` dict
plus free-form meta.  ``check_regression`` compares a run against the
trailing window of its predecessors with a tolerance band wide enough
to survive noisy CPU runners: the band is the larger of a relative
tolerance around the window median and a robust noise estimate
(k · 1.4826 · MAD).  Until ``min_runs`` prior samples exist there is
nothing to regress against and the checker stays silent — the gate
tightens itself as the trajectory grows.

Metric direction is inferred from the name (``*_us``/``*_ms``/``*_s``
latencies are lower-better, ``*_per_s``/``*_ratio``/``*_speedup``
throughputs higher-better, anything else two-sided) and can be
overridden per metric.

Corrupt or missing trajectory files never fail a bench run: ``load``
degrades to a fresh history and records why in ``note``.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict, List, Mapping, Optional

HISTORY_SCHEMA = 1

_LOWER_SUFFIXES = ("_us", "_ms", "_s", "_bytes", "_latency")
_HIGHER_MARKERS = ("_per_s", "_ratio", "_speedup", "_tps", "over_off")


def metric_direction(name: str) -> str:
    """'lower' | 'higher' | 'both' — which way is worse, by convention
    of the metric name."""
    if any(m in name for m in _HIGHER_MARKERS):
        return "higher"
    if name.endswith(_LOWER_SUFFIXES):
        return "lower"
    return "both"


def _fresh(note: Optional[str] = None) -> Dict[str, Any]:
    hist: Dict[str, Any] = {"schema": HISTORY_SCHEMA, "bench": None,
                            "runs": []}
    if note:
        hist["note"] = note
    return hist


def load_history(path: str) -> Dict[str, Any]:
    """Read a trajectory file; missing/corrupt/foreign-schema files
    degrade to a fresh history (reason in ``note``) — a bad file on
    disk must never fail a bench run."""
    if not os.path.exists(path):
        return _fresh()
    try:
        with open(path) as f:
            hist = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        return _fresh(f"unreadable trajectory discarded: {e}")
    if (not isinstance(hist, dict)
            or hist.get("schema") != HISTORY_SCHEMA
            or not isinstance(hist.get("runs"), list)):
        return _fresh(f"schema mismatch (want {HISTORY_SCHEMA}), discarded")
    return hist


def append_run(path: str, bench: str, metrics: Mapping[str, float],
               meta: Optional[Mapping[str, Any]] = None,
               now: Optional[float] = None) -> Dict[str, Any]:
    """Append one run to the trajectory at ``path`` (atomic tmp+rename
    write) and return the stored run record.  Non-finite or non-numeric
    metric values are dropped rather than poisoning the baseline."""
    clean = {}
    for k, v in metrics.items():
        try:
            fv = float(v)
        except (TypeError, ValueError):
            continue
        if fv == fv and abs(fv) != float("inf"):   # finite
            clean[str(k)] = fv
    run = {"ts": float(now if now is not None else time.time()),
           "metrics": clean, "meta": dict(meta or {})}
    hist = load_history(path)
    hist["bench"] = bench
    hist["runs"].append(run)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(hist, f, indent=1)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return run


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def check_regression(history: Mapping[str, Any],
                     metrics: Optional[Mapping[str, float]] = None, *,
                     window: int = 8, min_runs: int = 3,
                     rel_tol: float = 0.25, noise_k: float = 4.0,
                     directions: Optional[Mapping[str, str]] = None
                     ) -> List[Dict[str, Any]]:
    """Compare ``metrics`` (default: the trajectory's last run) against
    the trailing ``window`` of prior runs; return one problem record
    per metric outside its tolerance band.  Band =
    max(rel_tol·|median|, noise_k·1.4826·MAD) — never tighter than the
    observed run-to-run noise."""
    runs = list(history.get("runs", []))
    if metrics is None:
        if not runs:
            return []
        metrics, runs = runs[-1]["metrics"], runs[:-1]
    problems = []
    for name, val in metrics.items():
        prior = [r["metrics"][name] for r in runs[-window:]
                 if name in r.get("metrics", {})]
        if len(prior) < min_runs:
            continue
        base = _median(prior)
        mad = _median([abs(p - base) for p in prior])
        band = max(rel_tol * abs(base), noise_k * 1.4826 * mad, 1e-12)
        d = (directions or {}).get(name, metric_direction(name))
        worse = (val > base + band if d == "lower"
                 else val < base - band if d == "higher"
                 else abs(val - base) > band)
        if worse:
            problems.append({"metric": name, "value": float(val),
                             "baseline": base, "band": band,
                             "direction": d, "n_prior": len(prior)})
    return problems
