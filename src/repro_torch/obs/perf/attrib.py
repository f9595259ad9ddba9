"""Per-site attribution: measured decode time × analytic cost × FIT
(port of ``repro.obs.perf.attrib``).

``attribute`` distributes a MEASURED decode wall across the tree's
kernel sites in proportion to each site's share of the analytic
per-step roofline time (its memory- or compute-bound kernel time from
``obs.perf.cost``) — analytic *shares* of a measured *total*, so
the ms column sums to what the device actually spent.  Each row also
carries the site's FIT score (trace × quantization noise power at the
site's realized width, the same per-site contribution
``core.fit.fit_weights`` sums) when a calibrated SensitivityReport is
supplied — the measured quality-vs-cost Pareto per site.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

from repro_torch.obs.perf.cost import (
    HBM_BW, INT8_OPS, PEAK_FLOPS, KernelCost)


@dataclasses.dataclass(frozen=True)
class SiteRow:
    site: str
    kind: str
    bits: int
    fit: Optional[float]          # None when the report has no entry
    predicted_bytes: float        # per decode step
    byte_share: float             # fraction of per-step bytes moved
    measured_ms: float            # share of the measured decode wall
    time_share: float             # fraction of per-step roofline time
    bound: str                    # "memory" | "compute"

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def site_fit(report: Any, site: str, bits: int) -> Optional[float]:
    """The site's FIT contribution at ``bits``: weight-trace ×
    uniform-quantization noise power over the calibrated range."""
    if report is None or site not in getattr(report, "weight_traces", {}):
        return None
    from repro_torch.quant.noise import noise_power
    lo, hi = report.weight_ranges[site]
    return float(report.weight_traces[site]) * float(
        noise_power(lo, hi, bits))


def attribute(costs: Mapping[str, KernelCost], decode_s: float,
              report: Any = None, *, hbm_bw: float = HBM_BW,
              peak_flops: float = PEAK_FLOPS,
              int8_ops: float = INT8_OPS) -> List[SiteRow]:
    """Rows sorted by measured ms, descending.  ``decode_s`` is the
    measured decode wall being attributed (whole run or per step — the
    shares are scale-free)."""
    if not costs:
        return []
    site_t = {s: c.times(hbm_bw, peak_flops, int8_ops)
              for s, c in costs.items()}
    total_t = sum(t["kernel_s"] for t in site_t.values()) or 1.0
    total_b = sum(c.bytes for c in costs.values()) or 1.0
    rows = []
    for s, c in costs.items():
        share = site_t[s]["kernel_s"] / total_t
        rows.append(SiteRow(
            site=s, kind=c.kind, bits=c.bits,
            fit=site_fit(report, s, c.bits),
            predicted_bytes=c.bytes, byte_share=c.bytes / total_b,
            measured_ms=1e3 * decode_s * share, time_share=share,
            bound=site_t[s]["bound"]))
    rows.sort(key=lambda r: -r.measured_ms)
    return rows


def format_table(rows: List[SiteRow], top: Optional[int] = None) -> str:
    """Fixed-width text table: site -> (FIT, predicted bytes, ms)."""
    shown = rows if top is None else rows[:top]
    w = max([len(r.site) for r in shown] + [4])
    head = (f"{'site':<{w}}  {'kind':<15} {'bits':>4} {'FIT':>10} "
            f"{'bytes/step':>12} {'byte%':>6} {'ms':>9} {'time%':>6} bound")
    lines = [head, "-" * len(head)]
    for r in shown:
        fit = f"{r.fit:.3e}" if r.fit is not None else "-"
        lines.append(
            f"{r.site:<{w}}  {r.kind:<15} {r.bits:>4} {fit:>10} "
            f"{r.predicted_bytes:>12.0f} {100 * r.byte_share:>5.1f}% "
            f"{r.measured_ms:>9.3f} {100 * r.time_share:>5.1f}% {r.bound}")
    if top is not None and len(rows) > top:
        rest = rows[top:]
        ms = sum(r.measured_ms for r in rest)
        by = sum(r.predicted_bytes for r in rest)
        lines.append(f"{f'... {len(rest)} more sites':<{w}}  "
                     f"{'':<15} {'':>4} {'':>10} {by:>12.0f} {'':>6} "
                     f"{ms:>9.3f}")
    return "\n".join(lines)
