"""Materialize a FIT-derived ``BitConfig`` as packed QTensor storage
(port of ``repro.serve.quantized``).

``quantize_params`` turns every matmul block the config quantizes into a
packed QTensor (int8 at W8, 4-values-in-3-bytes at W6, nibbles at W4/W3)
with per-output-channel, optionally per-group, scales; the engine runs
them through ``DequantContext``. The legacy int8-backed format and the
tensor-parallel placement wait for later slices.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.core.fit import SensitivityReport
from repro_torch.core.mpq import greedy_allocate
from repro_torch.models.context import DequantContext
from repro_torch.qtensor import quantize as qt_quantize, tree_payload_bytes
from repro_torch.quant.policy import BitConfig, QuantPolicy
from repro_torch.utils.pytree import map_with_names, named_leaves

log = logging.getLogger("repro_torch.serve.quantized")

# Leaf names reached through ctx.matmul in the decode graph
MATMUL_LEAVES = frozenset({
    "wq", "wk", "wv", "wo",
    "w_up", "w_gate", "w_down",
    "wz", "wx", "wB", "wC", "wdt", "out_proj",
    "head", "router",
})


def qw_path(leaf_path: str) -> str:
    """Parameter-tree leaf path -> the scoped path ``ctx.matmul`` sees
    (they differ only for MoE shared experts)."""
    return leaf_path.replace("shared/w_", "shared_w_")


def _bit_config(params, bits: Union[int, BitConfig],
                policy: QuantPolicy) -> BitConfig:
    if isinstance(bits, int):
        wb = {name: bits for name, _ in named_leaves(params)}
        return policy.sanitize(BitConfig(wb, {}))
    return policy.sanitize(bits)


def _block_bits(bit_cfg: BitConfig, name: str, leaf,
                policy: QuantPolicy) -> Optional[int]:
    """Bits this leaf should be stored at, or None to keep it fp."""
    tail = name.split("/")[-1]
    b = bit_cfg.weight_bits.get(qw_path(name),
                                bit_cfg.weight_bits.get(name, 16))
    if (tail not in MATMUL_LEAVES or b >= 16
            or not policy.quantizable(name, leaf.ndim)):
        return None
    return b


def quantize_params(params, bits: Union[int, BitConfig],
                    policy: Optional[QuantPolicy] = None,
                    group_size: Optional[int] = None,
                    device: DeviceLike = None
                    ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """PTQ the matmul blocks of ``params`` into packed QTensors on
    ``device`` (default: the GPU). Returns ``(qparams, scales)`` with
    ``scales`` keyed by scoped path (reporting convenience)."""
    dev = resolve_device(device)
    layers = params.get("layers")
    if not (isinstance(layers, dict) and "0" in layers):
        raise ValueError("quantized serving needs the unrolled parameter "
                         "layout (layers/<i>/...)")
    policy = policy or QuantPolicy()
    bit_cfg = _bit_config(params, bits, policy)
    scales: Dict[str, torch.Tensor] = {}
    hist: Dict[int, int] = {}

    def one(name, leaf):
        leaf = leaf.to(dev)
        b = _block_bits(bit_cfg, name, leaf, policy)
        if b is None:
            return leaf
        if leaf.ndim != 2:
            raise NotImplementedError(
                f"{name}: only 2-D matmul blocks are ported (got "
                f"{tuple(leaf.shape)})")
        qt = qt_quantize(leaf, b, group_size=group_size)
        scales[qw_path(name)] = qt.scale
        hist[b] = hist.get(b, 0) + 1
        return qt

    qparams = map_with_names(one, params)
    log.info("QTensor PTQ: %d blocks packed %s; %.0f payload bytes",
             sum(hist.values()), dict(sorted(hist.items())),
             tree_payload_bytes(qparams))
    return qparams, scales


def make_dequant_context(cfg: ModelConfig, scales=None,
                         int8_compute: bool = False) -> DequantContext:
    return DequantContext(scales, cfg.param_dtype, int8_compute=int8_compute)


def bit_config_from_report(report: SensitivityReport,
                           policy: Optional[QuantPolicy] = None,
                           avg_bits: float = 8.0) -> BitConfig:
    """FIT policy -> serving BitConfig: greedy knapsack at an average
    weight budget of ``avg_bits`` bits/param (activations left fp)."""
    policy = policy or QuantPolicy()
    total = sum(report.param_sizes.values())
    cfg = greedy_allocate(report, policy, budget_bits=avg_bits * total)
    return BitConfig(cfg.weight_bits, {})
