"""Port of ``repro.serve`` — the continuous-batching quantized inference
engine: materialize a FIT ``BitConfig`` as packed QTensor storage
(``quantize_params``) or int8-backed storage (``quantize_params_int8``)
and serve it under request loads with continuous batching, greedy or
sampled (per-request seeded temperature / top-k / top-p), optionally
over a paged KV cache with prefix sharing (``EngineConfig(kv_cache=
"paged")``, ``repro_torch.kvcache``), on one device or sharded across a
tensor-parallel mesh (``EngineConfig(mesh=...)``, ``shard_params``), and
with self-speculative decoding (``EngineConfig(spec=SpecConfig(...))``:
a FIT-narrowed draft of the same tree, an exact verify)."""
from repro_torch.kvcache.fit import allocate_kv_bits, kv_bit_config, kv_report_fns
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.loadgen import poisson_requests, synth_prompt, trace_requests
from repro_torch.serve.metrics import EngineMetrics
from repro_torch.serve.quantized import (
    bit_config_from_report, make_dequant_context, quantize_params,
    quantize_params_int8, shard_params, sharded_storage_bytes,
    weight_storage_bytes)
from repro_torch.serve.request import Request, RequestStatus
from repro_torch.serve.sampling import SamplingParams, request_keys, sample_tokens
from repro_torch.serve.spec import SpecConfig, derive_draft_params

__all__ = [
    "Engine", "EngineConfig", "EngineMetrics", "Request", "RequestStatus",
    "SamplingParams", "SpecConfig", "allocate_kv_bits",
    "bit_config_from_report", "derive_draft_params", "kv_bit_config",
    "kv_report_fns", "make_dequant_context", "poisson_requests",
    "quantize_params", "quantize_params_int8", "request_keys",
    "sample_tokens", "shard_params", "sharded_storage_bytes",
    "synth_prompt", "trace_requests", "weight_storage_bytes",
]
