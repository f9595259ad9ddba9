"""Packed quantized-tensor storage (port of ``repro.qtensor``)."""
from repro_torch.qtensor.qtensor import (  # noqa: F401
    PACKED_BITS, QTensor, bytes_per_element, expand_scale, expert_slice,
    is_qtensor, logical_size, pack, pack_unit, packed_size, qmax_for_bits,
    quantize, quantize_experts, quantize_values, shard, shard_error,
    storage_summary, tree_has_qtensor, tree_payload_bytes, unpack,
    unpack_rows)
