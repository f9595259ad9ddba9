"""Paged, FIT-quantized KV cache (port of ``repro.kvcache``): the host
``allocator`` (free-list recycling, prefix sharing with copy-on-write,
reservations), the device page pools in ``paged`` (per-layer widths on
the ``qtensor`` layouts, per-page per-kv-head scales, sharded by kv head
under tensor parallelism) and the FIT width allocation in ``fit``."""
from repro_torch.kvcache.allocator import BlockAllocator
from repro_torch.kvcache.fit import (
    allocate_kv_bits, kv_bit_config, kv_bits_from_config, kv_report_fns,
    kv_sites)
from repro_torch.kvcache.paged import (
    LayerPages, PagedKVConfig, PagedState, dense_kv_bytes, init_paged_kv,
    kv_layer_count, layer_page_bytes, per_shard_pool_bytes, pool_bytes)

__all__ = [
    "BlockAllocator", "LayerPages", "PagedKVConfig", "PagedState",
    "allocate_kv_bits", "dense_kv_bytes", "init_paged_kv", "kv_bit_config",
    "kv_bits_from_config", "kv_layer_count", "kv_report_fns", "kv_sites",
    "layer_page_bytes", "per_shard_pool_bytes", "pool_bytes",
]
