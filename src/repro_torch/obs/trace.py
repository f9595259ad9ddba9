"""Span tracing: per-request lifecycle + per-dispatch spans (port of
``repro.obs.trace``; the Chrome trace and the jsonl log keep its schema,
so one validator reads both packages' files).

Host-side, append-only, and cheap (one ``perf_counter`` + dict append
per span edge): the engine opens a span per request at admission and
closes it at eviction (each request gets its own trace thread, so its
admit / prefill-chunk / gather / evict children nest inside it), and
puts batch-wide work — decode bursts, counter drains — on the engine
thread.  Export is Chrome trace-event JSON (open in Perfetto:
https://ui.perfetto.dev, "Open trace file") plus a structured jsonl
event log for grepping.

Disabled tracers swallow every call through a shared null context so an
un-traced serve pays two attribute loads per site.
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, List, Optional, Tuple

ENGINE_TID = 0          # batch-wide spans (bursts, drains, warmup)
_REQ_TID_BASE = 1       # request r -> tid r + 1
DEVICE_TID = -1         # device-timing track (sampled dispatch spans)


class Tracer:
    """Chrome-trace span recorder + jsonl event log."""

    def __init__(self, enabled: bool = True, pid: int = 1):
        self.enabled = enabled
        self.pid = pid
        self._t0 = time.perf_counter()
        self._events: List[Dict[str, Any]] = []      # trace events
        self._log: List[Dict[str, Any]] = []         # jsonl records
        self._open: Dict[int, Tuple[str, str, int, float, Dict]] = {}
        self._next_id = 0
        self._named_tids: set = set()
        if enabled:
            self._meta("process_name", {"name": "repro_torch.serve"})
            self._name_tid(ENGINE_TID, "engine")

    # -- clock ----------------------------------------------------------
    def _us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    # -- chrome metadata ------------------------------------------------
    def _meta(self, name: str, args: Dict, tid: int = 0) -> None:
        self._events.append({"ph": "M", "name": name, "pid": self.pid,
                             "tid": tid, "args": args})

    def _name_tid(self, tid: int, name: str) -> None:
        if tid not in self._named_tids:
            self._named_tids.add(tid)
            self._meta("thread_name", {"name": name}, tid=tid)

    def request_tid(self, req_id: int) -> int:
        tid = _REQ_TID_BASE + int(req_id)
        if self.enabled:
            self._name_tid(tid, f"req {int(req_id)}")
        return tid

    def device_tid(self) -> int:
        """The device-timing track (``obs.perf.timing`` mirrors
        sampled dispatch spans here, sibling to the engine thread)."""
        if self.enabled:
            self._name_tid(DEVICE_TID, "device")
        return DEVICE_TID

    def now_us(self) -> float:
        """Trace-clock timestamp (µs since tracer start) — lets callers
        that measured a duration themselves place a complete span."""
        return self._us()

    # -- spans ----------------------------------------------------------
    def begin(self, name: str, cat: str = "serve", tid: int = ENGINE_TID,
              args: Optional[Dict] = None) -> Optional[int]:
        """Open a span; returns a handle for :meth:`end` (None if off)."""
        if not self.enabled:
            return None
        sid = self._next_id
        self._next_id += 1
        self._open[sid] = (name, cat, tid, self._us(), dict(args or {}))
        return sid

    def end(self, sid: Optional[int],
            args: Optional[Dict] = None) -> None:
        if sid is None or sid not in self._open:
            return
        name, cat, tid, ts, a = self._open.pop(sid)
        if args:
            a.update(args)
        self._events.append({
            "ph": "X", "name": name, "cat": cat, "pid": self.pid,
            "tid": tid, "ts": ts, "dur": max(self._us() - ts, 0.0),
            "args": a})

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "serve", tid: int = ENGINE_TID,
             args: Optional[Dict] = None):
        if not self.enabled:
            yield None
            return
        sid = self.begin(name, cat, tid, args)
        try:
            yield sid
        finally:
            self.end(sid)

    def complete(self, name: str, ts_us: float, dur_us: float,
                 cat: str = "device", tid: int = DEVICE_TID,
                 args: Optional[Dict] = None) -> None:
        """Append an already-measured complete ("X") span at an explicit
        [ts, ts+dur] on the trace clock — used for the device-timing
        track, where the duration is known only after the sync."""
        if not self.enabled:
            return
        self._events.append({
            "ph": "X", "name": name, "cat": cat, "pid": self.pid,
            "tid": tid, "ts": float(ts_us), "dur": max(float(dur_us), 0.0),
            "args": dict(args or {})})

    def instant(self, name: str, tid: int = ENGINE_TID,
                args: Optional[Dict] = None) -> None:
        if not self.enabled:
            return
        self._events.append({"ph": "i", "name": name, "cat": "serve",
                             "pid": self.pid, "tid": tid, "ts": self._us(),
                             "s": "t", "args": dict(args or {})})

    # -- structured event log -------------------------------------------
    def event(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        rec = {"ts_us": self._us(), "kind": kind}
        rec.update(fields)
        self._log.append(rec)

    # -- export ---------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """The Perfetto-loadable trace object (open spans are dropped)."""
        return {"traceEvents": list(self._events), "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def write_events(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self._log:
                f.write(json.dumps(rec) + "\n")

    @property
    def n_events(self) -> int:
        return len(self._events)


# ---------------------------------------------------------------------------
# validation (tests + the CI obs smoke step)
# ---------------------------------------------------------------------------

def validate_chrome_trace(obj: Any) -> List[str]:
    """Schema + nesting check; returns a list of problems (empty = ok).

    * top level: ``{"traceEvents": [...]}``;
    * every complete event (``ph == "X"``) carries numeric ``ts``/``dur``
      (``dur >= 0``), a ``name``, ``pid``/``tid``;
    * per (pid, tid), complete events NEST: sorted by start (ties: longer
      first), each event lies fully inside the enclosing open span —
      request spans must contain their admit/prefill/evict children.
    """
    problems: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a traceEvents list"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents must be a list"]
    complete: Dict[Tuple[Any, Any], List[Tuple[float, float, str]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph is None or "name" not in ev:
            problems.append(f"event {i}: missing ph/name")
            continue
        if ph == "X":
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)) or \
                    not isinstance(dur, (int, float)) or dur < 0:
                problems.append(
                    f"event {i} ({ev.get('name')}): ts/dur must be "
                    f"numeric with dur >= 0 (got ts={ts!r} dur={dur!r})")
                continue
            if "pid" not in ev or "tid" not in ev:
                problems.append(f"event {i} ({ev.get('name')}): no pid/tid")
                continue
            complete.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ts), float(dur), str(ev["name"])))
    for (pid, tid), evs in sorted(complete.items(), key=lambda kv: (
            str(kv[0][0]), str(kv[0][1]))):
        evs.sort(key=lambda e: (e[0], -e[1]))
        stack: List[Tuple[float, float, str]] = []
        for ts, dur, name in evs:
            while stack and ts >= stack[-1][0] + stack[-1][1] - 1e-9:
                stack.pop()
            if stack:
                p_ts, p_dur, p_name = stack[-1]
                if ts + dur > p_ts + p_dur + 1e-6:
                    problems.append(
                        f"tid {tid}: span '{name}' [{ts:.1f}, "
                        f"{ts + dur:.1f}] overlaps but does not nest "
                        f"inside '{p_name}' [{p_ts:.1f}, "
                        f"{p_ts + p_dur:.1f}]")
            stack.append((ts, dur, name))
    return problems
