"""Device-timed dispatch spans for the serving engine (port of
``repro.obs.perf.timing``).

The host wall is the reference's: each prefill-chunk / decode-burst
dispatch already ends in the engine's one host read, so the wall around
it bounds the dispatch. On the card the port adds the device's own time
of the dispatch: a ``DeviceSpan`` records a CUDA event before the
dispatch's first launch and one after its last, and reads
``elapsed_time`` only after that existing host read — no sync is added.

There is no jit cache, so the compile-versus-execute split has its own
rule: a dispatch is ``compiled`` when the kernel library was built or
loaded during it (``kernels._build.loads`` stepped); its wall is booked
to ``compile_s`` so steady-state ``exec_s`` stays uncontaminated. On the
CPU no library is loaded, and the flag is never set.

Every ``time_every``-th sample per kind is mirrored onto the Chrome
trace's "device" track (``Tracer.complete`` on ``DEVICE_TID``), from the
dispatch's start, lasting its device time where one was measured and its
wall otherwise; aggregation always sees every sample.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.obs.trace import Tracer

KINDS = ("prefill_chunk", "decode_burst", "drain")


class DeviceSpan:
    """CUDA events around one dispatch on ``device`` (nothing on the
    CPU), and the kernel loader's count at its start."""

    def __init__(self, device: torch.device):
        from repro_torch.kernels import _build
        self._loads = _build.loads
        self._events = None
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True), stream)
            self._events[0].record(stream)

    def stop(self) -> None:
        """Mark the dispatch's last launch (before its host read)."""
        if self._events is not None:
            self._events[1].record(self._events[2])

    def read(self) -> Tuple[Optional[float], bool]:
        """(device seconds or None, compiled) — call after the dispatch's
        host read, which has already waited for the end event."""
        from repro_torch.kernels import _build
        dev = None
        if self._events is not None:
            dev = 1e-3 * self._events[0].elapsed_time(self._events[1])
        return dev, _build.loads != self._loads


@dataclasses.dataclass
class KindStats:
    """Aggregates for one dispatch kind."""
    count: int = 0
    wall_s: float = 0.0
    exec_s: float = 0.0       # steady-state dispatch walls
    compile_s: float = 0.0    # walls of dispatches that built/loaded kernels
    compiled: int = 0
    tokens: int = 0
    sampled: int = 0          # dispatches mirrored onto the device track
    device_s: float = 0.0     # CUDA-event time of the dispatches timed so
    device_timed: int = 0     # (the card only)
    device_over_wall_max: float = 0.0   # largest device / host wall ratio


class DispatchTimer:
    """Host-side aggregator for timed dispatch samples."""

    def __init__(self, time_every: int = 1):
        if time_every < 1:
            raise ValueError(f"time_every must be >= 1, got {time_every}")
        self.time_every = int(time_every)
        self.stats: Dict[str, KindStats] = {k: KindStats() for k in KINDS}

    def record(self, kind: str, wall_s: float, *, tokens: int = 0,
               compiled: bool = False, tracer: Optional[Tracer] = None,
               args: Optional[Dict[str, Any]] = None,
               device_s: Optional[float] = None) -> None:
        """Book one dispatch's host wall (and its device time, where
        measured); mirror every ``time_every``-th sample per kind onto
        the device track."""
        st = self.stats.setdefault(kind, KindStats())
        st.count += 1
        st.wall_s += wall_s
        st.tokens += int(tokens)
        if compiled:
            st.compiled += 1
            st.compile_s += wall_s
        else:
            st.exec_s += wall_s
        if device_s is not None:
            st.device_s += device_s
            st.device_timed += 1
            if wall_s > 0:
                st.device_over_wall_max = max(st.device_over_wall_max,
                                              device_s / wall_s)
        if (tracer is not None and tracer.enabled
                and (st.count - 1) % self.time_every == 0):
            st.sampled += 1
            a: Dict[str, Any] = {"compiled": bool(compiled)}
            if tokens:
                a["tokens"] = int(tokens)
            if device_s is not None:
                a["wall_ms"] = 1e3 * wall_s
                a["device_ms"] = 1e3 * device_s
            if args:
                a.update(args)
            end = tracer.now_us()
            dur = wall_s if device_s is None else min(device_s, wall_s)
            tracer.complete(f"device:{kind}", end - wall_s * 1e6, dur * 1e6,
                            cat="device", tid=tracer.device_tid(), args=a)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-kind aggregate dict (kinds with no samples omitted)."""
        out: Dict[str, Dict[str, float]] = {}
        for kind, st in self.stats.items():
            if not st.count:
                continue
            steady = st.count - st.compiled
            out[kind] = {
                "count": st.count, "wall_s": st.wall_s,
                "exec_s": st.exec_s, "compile_s": st.compile_s,
                "compiled": st.compiled, "tokens": st.tokens,
                "sampled": st.sampled,
                "mean_exec_ms": 1e3 * st.exec_s / steady if steady else 0.0,
                "device_s": st.device_s, "device_timed": st.device_timed,
                "mean_device_ms": (1e3 * st.device_s / st.device_timed
                                   if st.device_timed else 0.0),
                "device_over_wall_max": st.device_over_wall_max,
            }
        return out
