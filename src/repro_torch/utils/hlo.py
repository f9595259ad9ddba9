"""Collective ledgers and HLO text analysis (port of
``repro.utils.hlo``).

Two halves:

  * ``CollectiveStats``, filled by a ``launch.mesh.Mesh`` recorder
    (``mesh.recording(stats)``), which adds one entry for every
    collective the mesh's origin shard takes part in, with the bytes of
    that shard's output and the group size. The forward's collectives
    and the step's gradient and optimizer collectives are recorded; the
    backward's transposed collectives run inside autograd and are not.
    The reference fills the same class from its compiled step's HLO.
  * The text parser, copied from the reference (:24-31, :48-58,
    :153-236) and returning what it returns on the same text:
    ``cost_analysis_dict``, ``_split_computations``, ``collective_bytes``
    and ``count_op``. The port never produces HLO; these read the
    reference's artifacts (its dry-run JSON and HLO dumps) so they can
    be set beside the port's ledger (``launch.dryrun``).

The parser is schema-light: it scans instruction lines of the form
``%name = <shape> op-name(...)`` and decodes shapes like
``bf16[16,4096,4096]{...}``. Tuple shapes ``(f32[...], u32[...])`` sum
their elements.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional


def cost_analysis_dict(compiled) -> Dict[str, float]:
    """``compiled.cost_analysis()`` normalized across compiler versions: older
    releases return a one-element list of dicts (one per computation),
    newer ones a plain dict."""
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    return dict(cost)


COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^ ]*)\s+"
    r"([a-z0-9\-]+)[(.]"
)
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9, ]*)\}")
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->.*\{")
_WHILE_BODY_RE = re.compile(r"body=%?([\w.\-]+)")
_WHILE_COND_RE = re.compile(r"condition=%?([\w.\-]+)")
_CALLS_RE = re.compile(r"(?:to_apply|calls)=%?([\w.\-]+)")


def shape_bytes(shape_str: str, f32_as_bf16: bool = False) -> int:
    """Bytes of an HLO shape string such as ``bf16[16,4096]{1,0}`` (a
    tuple ``(f32[...], u32[...])`` sums its elements; 4-bit types pack
    two to a byte). ``f32_as_bf16`` counts f32 elements at 2 bytes."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        nbytes = _DTYPE_BYTES[dtype]
        if dtype in ("s4", "u4"):
            total += max(1, n // 2)
            continue
        if f32_as_bf16 and dtype == "f32":
            nbytes = 2
        total += n * nbytes
    return total


@dataclass
class CollectiveStats:
    """Per-kind collective byte totals.

    ``bytes_by_kind`` is raw output-shape bytes; ``traffic_by_kind`` is
    per-device ring-traffic bytes with participant-count factors:
      all-gather     out·(g−1)/g         (out = gathered, per-device)
      all-reduce     2·out·(g−1)/g       (reduce-scatter + all-gather ring)
      reduce-scatter out·(g−1)           (out = shard; total reduced = out·g)
      all-to-all     out·(g−1)/g
      collective-permute out
    """

    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    traffic_by_kind: Dict[str, float] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_traffic(self) -> float:
        return sum(self.traffic_by_kind.values())

    def add(self, kind: str, nbytes: int, group_size: int = 2,
            mult: float = 1.0) -> None:
        g = max(group_size, 1)
        if g == 1:
            traffic = 0.0
        elif kind == "all-reduce":
            traffic = 2.0 * nbytes * (g - 1) / g
        elif kind == "reduce-scatter":
            traffic = float(nbytes) * (g - 1)
        elif kind == "collective-permute":
            traffic = float(nbytes)
        else:  # all-gather / all-to-all
            traffic = float(nbytes) * (g - 1) / g
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + int(nbytes * mult)
        self.traffic_by_kind[kind] = self.traffic_by_kind.get(kind, 0.0) + traffic * mult
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1

    def merge(self, other: "CollectiveStats", mult: float = 1.0) -> None:
        for k, v in other.bytes_by_kind.items():
            self.bytes_by_kind[k] = self.bytes_by_kind.get(k, 0) + int(v * mult)
        for k, v in other.traffic_by_kind.items():
            self.traffic_by_kind[k] = self.traffic_by_kind.get(k, 0.0) + v * mult
        for k, v in other.count_by_kind.items():
            self.count_by_kind[k] = self.count_by_kind.get(k, 0) + v

    def scaled_diff(self, base: "CollectiveStats", mult: float) -> "CollectiveStats":
        """self + (self − base)·mult — the per-layer extrapolation."""
        out = CollectiveStats()
        kinds = sorted(set(self.bytes_by_kind) | set(base.bytes_by_kind))
        for k in kinds:
            b2, b1 = self.bytes_by_kind.get(k, 0), base.bytes_by_kind.get(k, 0)
            t2, t1 = self.traffic_by_kind.get(k, 0.0), base.traffic_by_kind.get(k, 0.0)
            out.bytes_by_kind[k] = int(b2 + (b2 - b1) * mult)
            out.traffic_by_kind[k] = t2 + (t2 - t1) * mult
            out.count_by_kind[k] = self.count_by_kind.get(k, 0)
        return out


def _split_computations(hlo_text: str) -> Dict[str, List[str]]:
    """Map computation name -> its instruction lines."""
    comps: Dict[str, List[str]] = {}
    current: Optional[str] = None
    for line in hlo_text.splitlines():
        m = _COMP_RE.match(line.strip())
        if m and "{" in line:
            current = m.group(1)
            comps[current] = []
            continue
        if current is not None:
            if line.strip().startswith("}"):
                current = None
                continue
            comps[current].append(line)
    return comps


def collective_bytes(
    hlo_text: str, while_trip_counts: Optional[Dict[str, float]] = None,
    default_trip_count: float = 1.0, f32_as_bf16: bool = False,
) -> CollectiveStats:
    """Sum collective traffic in an HLO module.

    ``while_trip_counts`` maps a substring of the while *body* computation
    name to its trip count (e.g. ``{"body": 32}``). Any while body whose
    name matches no entry uses ``default_trip_count``. The ``-done``
    half of an async pair is skipped (its ``-start`` is counted).
    """
    comps = _split_computations(hlo_text)

    # which computations are while bodies / conditions, and their trip counts
    body_mult: Dict[str, float] = {}
    for lines in comps.values():
        for line in lines:
            if " while(" in line or "= while(" in line.replace("  ", " "):
                mb = _WHILE_BODY_RE.search(line)
                if mb:
                    name = mb.group(1)
                    mult = default_trip_count
                    for key, tc in (while_trip_counts or {}).items():
                        if key in name:
                            mult = tc
                            break
                    body_mult[name] = mult
                mc = _WHILE_COND_RE.search(line)
                if mc:
                    body_mult.setdefault(mc.group(1), 1.0)

    stats = CollectiveStats()
    for comp_name, lines in comps.items():
        mult = body_mult.get(comp_name, 1.0)
        for line in lines:
            m = _INSTR_RE.match(line)
            if not m:
                continue
            shape_str, op = m.group(1), m.group(2)
            base = None
            for kind in COLLECTIVE_OPS:
                if op == kind or op.startswith(kind + "-"):
                    base = None if op.endswith("-done") else kind
                    break
            if base is None:
                continue
            gsize = 2
            mg = _GROUPS_IOTA_RE.search(line)
            if mg:
                gsize = int(mg.group(2))
            else:
                ml = _GROUPS_LIST_RE.search(line)
                if ml:
                    gsize = len([t for t in ml.group(1).split(",") if t.strip()])
            stats.add(base, shape_bytes(shape_str, f32_as_bf16), gsize, mult)
    return stats


def count_op(hlo_text: str, opname: str) -> int:
    return len(re.findall(rf"\b{re.escape(opname)}\(", hlo_text))
