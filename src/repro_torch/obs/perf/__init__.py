"""repro_torch.obs.perf — performance observability (port of
``repro.obs.perf``).

Three views of the serving hot path, joined per site:

  measured  (``timing``)  — timed dispatch spans: the host wall around
      each dispatch's one host read and, on the card, CUDA-event device
      time, in a host-side aggregator with a compile-vs-execute split
      (kernel library loads), mirrored onto a "device" track of the
      Chrome trace;
  predicted (``cost``)    — closed-form bytes-moved / op counts per
      kernel from the real packed layouts (qmm, paged_attention,
      int8_matmul), composed into a per-site roofline;
  attributed (``attrib``) — the join of both with the calibrated
      SensitivityReport: site -> (FIT score, predicted bytes,
      measured ms share) — the measured quality-vs-cost Pareto.

``history`` stores schema-versioned bench trajectories and runs the
noise-aware regression gate over them.

``cost``/``attrib`` reach into the model stack lazily (inside
functions); this namespace itself stays import-cycle-free the same way
``repro_torch.obs`` does.
"""
from repro_torch.obs.perf.attrib import (
    SiteRow, attribute, format_table, site_fit)
from repro_torch.obs.perf.cost import (
    HBM_BW, INT8_OPS, PEAK_FLOPS, KernelCost, fp_matmul_cost,
    grouped_qmm_cost, grouped_qmm_weight_bytes, int8_matmul_cost,
    kv_pool_bytes, paged_attention_cost, qmm_cost, qmm_weight_bytes,
    roofline, site_costs_from_tree)
from repro_torch.obs.perf.history import (
    HISTORY_SCHEMA, append_run, check_regression, load_history,
    metric_direction)
from repro_torch.obs.perf.timing import DispatchTimer

__all__ = [
    "HBM_BW", "HISTORY_SCHEMA", "INT8_OPS", "PEAK_FLOPS", "DispatchTimer",
    "KernelCost", "SiteRow", "append_run", "attribute", "check_regression",
    "format_table", "fp_matmul_cost", "grouped_qmm_cost",
    "grouped_qmm_weight_bytes", "int8_matmul_cost", "kv_pool_bytes",
    "load_history", "metric_direction", "paged_attention_cost", "qmm_cost",
    "qmm_weight_bytes", "roofline", "site_costs_from_tree", "site_fit",
]
