"""repro_torch.obs — serving observability (port of ``repro.obs``).

Four layers over the continuous-batching engine:

  1. span tracing (``trace``)        — per-request lifecycle + per-
     dispatch spans, Chrome trace-event JSON (Perfetto) + jsonl log;
  2. zero-sync device metrics (``runtime``/``counters``) — host-known
     counts summed on the host, data-dependent ones added in place on
     the device, drained in bulk on a cadence (the metrics layer's only
     host transfer);
  3. gauges + exposition (``gauges``/``prom``) — page pool, prefix
     sharing, per-shard HBM, kernel-library loads, Prometheus text
     format;
  4. FIT drift monitoring (``drift``) — online logit KL + activation-
     range drift vs the calibrated SensitivityReport, closing the loop
     between FIT's offline prediction and the live system;
  5. performance profiling (``perf``) — timed dispatch spans (the host
     wall around each dispatch's one host read, CUDA-event device time
     on the card), the analytic QTensor cost model at the H100's machine
     balance, per-site FIT/bytes/ms attribution, and bench-history
     regression gating.

``repro_torch.obs.drift`` imports the model stack, which imports this
package's ``runtime`` — import it as ``repro_torch.obs.drift`` directly
(kept out of this namespace to stay cycle-free); ``repro_torch.obs.perf``
is likewise imported directly (its cost/attrib modules reach the
serve/quant stacks lazily).
"""
from repro_torch.obs.config import ObsConfig
from repro_torch.obs.counters import DeviceCounters
from repro_torch.obs.gauges import GAUGE_HELP, collect_gauges, snapshot
from repro_torch.obs.prom import MetricsServer, parse, render, write_snapshot
from repro_torch.obs.runtime import (
    COUNTERS, CounterSink, collecting, ctr_add, ctr_get, emit, emitting,
    emitting_stats, fold, init_counters, suspended, unpack_counters)
from repro_torch.obs.trace import Tracer, validate_chrome_trace

__all__ = [
    "COUNTERS", "CounterSink", "DeviceCounters", "GAUGE_HELP",
    "MetricsServer", "ObsConfig", "Tracer", "collect_gauges", "collecting",
    "ctr_add", "ctr_get", "emit", "emitting", "emitting_stats", "fold",
    "init_counters", "parse", "render", "snapshot", "suspended",
    "unpack_counters", "validate_chrome_trace", "write_snapshot",
]
