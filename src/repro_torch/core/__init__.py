"""Port of ``repro.core``: the FIT report, the metric and the bit
allocators (the modules the port holds so far)."""
from repro_torch.core.fit import (
    DraftPlan,
    PackedReport,
    SensitivityReport,
    allocate_draft_bits,
)
from repro_torch.core.mpq import (
    config_cost_bits,
    dp_allocate,
    greedy_allocate,
    pareto_front,
    sample_configs,
    sample_packed,
)
from repro_torch.core.report import act_ranges, build_report, weight_ranges
