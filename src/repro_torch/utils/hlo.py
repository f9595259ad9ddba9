"""Collective ledgers (port of the collective-stats half of
``repro.utils.hlo``, :36-150).

The reference fills ``CollectiveStats`` by parsing the compiled,
partitioned step's HLO text. The port has no compiled module: the
stats are filled by a ``launch.mesh.Mesh`` recorder
(``mesh.recording(stats)``), which adds one entry for every collective
the mesh's origin shard takes part in, with the bytes of that shard's
output and the group size. The forward's collectives and the step's
gradient and optimizer collectives are recorded; the backward's
transposed collectives run inside autograd and are not. The text parser
(``collective_bytes`` and its helpers) is not ported.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict

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
