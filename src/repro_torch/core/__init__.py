"""Port of ``repro.core``: EF and Hessian traces, the FIT report and
metric, the baseline heuristics, the bit allocators and the
rank-correlation protocol."""
from repro_torch.core.fisher import (  # noqa: F401
    ef_trace_weights,
    ef_trace_weights_streaming,
    ef_trace_activations,
    fisher_trace_exact,
)
from repro_torch.core.hessian import (  # noqa: F401
    hvp,
    hutchinson_block_traces,
    exact_block_traces,
)
from repro_torch.core.fit import (  # noqa: F401
    PackedReport,
    SensitivityReport,
    DraftPlan,
    allocate_draft_bits,
)
from repro_torch.core.heuristics import (  # noqa: F401
    ALL_METRICS,
    qr_metric,
    bn_metric,
    noise_metric,
    metric_packed,
    metric_values_batch,
)
from repro_torch.core.mpq import (  # noqa: F401
    greedy_allocate,
    dp_allocate,
    pareto_front,
    sample_configs,
    sample_packed,
    config_cost_bits,
)
from repro_torch.core.rankcorr import (  # noqa: F401
    spearman, pearson, kendall, metric_accuracy_correlation)
from repro_torch.core.report import (  # noqa: F401
    build_report, weight_ranges, act_ranges)
