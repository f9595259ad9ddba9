"""Port of ``repro.serve`` — the continuous-batching quantized inference
engine: materialize a FIT ``BitConfig`` as packed QTensor storage
(``quantize_params``) or int8-backed storage (``quantize_params_int8``)
and serve it under request loads with continuous batching, optionally
over a paged KV cache with prefix sharing (``EngineConfig(kv_cache=
"paged")``, ``repro_torch.kvcache``), on one device or sharded across a
tensor-parallel mesh (``EngineConfig(mesh=...)``, ``shard_params``). The
sampled-decoding and speculative exports of the reference are not
ported yet."""
from repro_torch.kvcache.fit import allocate_kv_bits, kv_report_fns
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.loadgen import poisson_requests, synth_prompt, trace_requests
from repro_torch.serve.metrics import EngineMetrics
from repro_torch.serve.quantized import (
    bit_config_from_report, make_dequant_context, quantize_params,
    quantize_params_int8, shard_params, sharded_storage_bytes,
    weight_storage_bytes)
from repro_torch.serve.request import Request, RequestStatus
from repro_torch.serve.sampling import SamplingParams

__all__ = [
    "Engine", "EngineConfig", "EngineMetrics", "Request", "RequestStatus",
    "SamplingParams", "allocate_kv_bits", "bit_config_from_report",
    "kv_report_fns", "make_dequant_context",
    "poisson_requests", "quantize_params", "quantize_params_int8",
    "shard_params", "sharded_storage_bytes", "synth_prompt",
    "trace_requests", "weight_storage_bytes",
]
