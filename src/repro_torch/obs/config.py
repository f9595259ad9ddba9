"""Observability switches for ``EngineConfig(obs=...)`` (port of
``repro.obs.config``, field for field).

Frozen + hashable so it can live inside the (frozen) EngineConfig.
Everything defaults OFF: an engine built without an ObsConfig pays
nothing on the hot path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """What to record and where to put it."""

    trace: bool = False           # span tracing + jsonl event log
    device_metrics: bool = False  # device counter accumulation + drains
    drain_every: int = 8          # bursts between counter drains (0: end only)
    stats_every: int = 4          # bursts between element-wise clip-stat
    #                               samples (act_sat / fq_clip reductions);
    #                               1 = every burst. Exact i32 counters
    #                               (tokens/steps/bursts) are never sampled.
    perf: bool = False            # CUDA-event-timed dispatch spans (obs.perf)
    time_every: int = 1           # per-kind cadence of device-track trace
    #                               mirroring; aggregation sees every sample
    trace_path: Optional[str] = None    # Chrome trace JSON output
    events_path: Optional[str] = None   # structured jsonl log output
    metrics_file: Optional[str] = None  # Prometheus text snapshot output
    metrics_port: Optional[int] = None  # live /metrics endpoint (0 = ephemeral)

    @property
    def enabled(self) -> bool:
        return self.trace or self.device_metrics or self.perf

    def __post_init__(self):
        if self.drain_every < 0:
            raise ValueError("drain_every must be >= 0")
        if self.stats_every < 1:
            raise ValueError("stats_every must be >= 1")
        if self.time_every < 1:
            raise ValueError("time_every must be >= 1")
