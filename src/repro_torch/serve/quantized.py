"""Materialize a FIT-derived ``BitConfig`` as quantized storage
(port of ``repro.serve.quantized``), in one of two formats:

  * ``quantize_params`` — every matmul block the config quantizes
    becomes a packed QTensor (int8 at W8, 4-values-in-3-bytes at W6,
    nibbles at W4/W3) with per-output-channel, optionally per-group,
    scales; 3-D MoE expert stacks get per-expert scales
    (``quantize_experts``). ``DequantContext`` runs them through ``qmm``.
  * ``quantize_params_int8`` — the int8-backed format: every quantized
    block is int8 with per-channel scales in a path-keyed dict, a b-bit
    block on the ±(2^(b-1)-1) sub-grid (no storage saved below 8 bits).
    ``DequantContext`` runs them through ``int8_matmul``. At W8 with
    default granularity the two formats dequantize identically.

Both need the unrolled layout (``layers/<i>/...``; the hybrid's
``shared/...``, ``groups/<g>/<i>/...`` and ``rest/<i>/...``). The Mamba2
conv weights and SSM vectors are not matmul leaves and stay fp. ``shard_params``
splits either tree across a ``launch.mesh.TPMesh`` for tensor-parallel
serving (``ShardedDequantContext``).
"""
from __future__ import annotations

import logging
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.core.fit import SensitivityReport
from repro_torch.core.mpq import greedy_allocate
from repro_torch.models.context import DequantContext
from repro_torch.qtensor import (
    QTensor, is_qtensor, qmax_for_bits, quantize as qt_quantize,
    quantize_experts as qt_quantize_experts, shard as qt_shard, shard_error,
    tree_payload_bytes)
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


def _require_unrolled(params) -> None:
    layers = params.get("layers") or params.get("groups")
    if not (isinstance(layers, dict) and "0" in layers):
        raise ValueError("quantized serving needs the unrolled parameter "
                         "layout (layers/<i>/... or the hybrid's "
                         "groups/<g>/<i>/...): storage is keyed by block "
                         "path, which a scan-stacked tree cannot give")


def quantize_params(params, bits: Union[int, BitConfig],
                    policy: Optional[QuantPolicy] = None,
                    group_size: Optional[int] = None,
                    device: DeviceLike = None
                    ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """PTQ the matmul blocks of ``params`` into packed QTensors on
    ``device`` (default: the GPU). Returns ``(qparams, scales)`` with
    ``scales`` keyed by scoped path (reporting convenience)."""
    dev = resolve_device(device)
    _require_unrolled(params)
    policy = policy or QuantPolicy()
    bit_cfg = _bit_config(params, bits, policy)
    scales: Dict[str, torch.Tensor] = {}
    hist: Dict[int, int] = {}

    def one(name, leaf):
        leaf = leaf.to(dev)
        b = _block_bits(bit_cfg, name, leaf, policy)
        if b is None:
            return leaf
        # expert stacks get per-expert (E, G, N) scale grids: each expert
        # is a self-contained qmm block, which the grouped kernel needs
        qt = (qt_quantize_experts(leaf, b, group_size=group_size)
              if leaf.ndim == 3 else
              qt_quantize(leaf, b, group_size=group_size))
        scales[qw_path(name)] = qt.scale
        hist[b] = hist.get(b, 0) + 1
        return qt

    qparams = map_with_names(one, params)
    log.info("QTensor PTQ: %d blocks packed %s; %.0f payload bytes",
             sum(hist.values()), dict(sorted(hist.items())),
             tree_payload_bytes(qparams))
    return qparams, scales


def quantize_params_int8(params, bits: Union[int, BitConfig],
                         policy: Optional[QuantPolicy] = None,
                         device: DeviceLike = None
                         ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """Int8-backed PTQ on ``device`` (default: the GPU): every quantized
    block stored as int8, a b-bit block on the ±(2^(b-1)-1) sub-grid —
    the grid ``quantize_params`` packs, so both formats dequantize to the
    same values. Returns ``(qparams, scales)``, scales keyed by scoped
    path and shaped to broadcast against the weight: (1, N), and
    (E, 1, N) for 3-D expert stacks."""
    dev = resolve_device(device)
    _require_unrolled(params)
    policy = policy or QuantPolicy()
    bit_cfg = _bit_config(params, bits, policy)
    scales: Dict[str, torch.Tensor] = {}

    def one(name, leaf):
        leaf = leaf.to(dev)
        b = _block_bits(bit_cfg, name, leaf, policy)
        if b is None:
            return leaf
        qmax = qmax_for_bits(b)
        w32 = leaf.to(torch.float32)
        # expert stacks keep the expert dim in the scale, matching
        # quantize_params' per-expert grids
        red = (1,) if leaf.ndim == 3 else tuple(range(leaf.ndim - 1))
        amax = torch.amax(torch.abs(w32), dim=red, keepdim=True)
        scale = torch.clamp_min(amax, 1e-12) / qmax
        scales[qw_path(name)] = scale
        return torch.clamp(torch.round(w32 / scale), -qmax, qmax).to(torch.int8)

    qparams = map_with_names(one, params)
    log.info("int8 PTQ: %d blocks quantized", len(scales))
    return qparams, scales


def weight_storage_bytes(params) -> float:
    """Realized weight-storage bytes of a tree: QTensor payloads packed
    (with their scales), every other leaf at its dtype size — int8-backed
    blocks at one byte per element."""
    return float(tree_payload_bytes(params))


# ---------------------------------------------------------------------------
# tensor-parallel sharded materialization (EngineConfig(mesh=...))
# ---------------------------------------------------------------------------

# Megatron-style layout per block tail: column-parallel blocks shard the
# output dim (no reduction crosses shards), row-parallel blocks shard the
# reduction dim (each shard owns whole scale groups; the combine folds
# the gathered group terms in order)
COL_PARALLEL = frozenset({"wq", "wk", "wv", "w_up", "w_gate",
                          "wz", "wx", "wB", "wC", "wdt", "head"})
ROW_PARALLEL = frozenset({"wo", "w_down", "out_proj"})
# 3-D stacked-expert blocks: sharded by EXPERT (dim 0), each shard owning
# whole self-contained (K, N) blocks with their per-expert scales
MOE_EXPERT_LEAVES = frozenset({"w_up", "w_gate", "w_down"})


def _plan_leaf(name: str, leaf, n_shards: int
               ) -> Tuple[Optional[str], Optional[str]]:
    """(layout, reason not sharded) of one parameter leaf: 2-D quantized
    storage (QTensor or int8-backed) shards "col"/"row" by its tail
    name, a 3-D per-expert QTensor stack "ep" when the experts divide
    the mesh; a block that fails alignment stays replicated, with the
    reason. Shared-scale and int8-backed expert stacks stay on the
    replicated path."""
    tail = name.split("/")[-1]
    if tail in COL_PARALLEL:
        mode, axis = "col", -1
    elif tail in ROW_PARALLEL:
        mode, axis = "row", 0
    else:
        return None, None
    if is_qtensor(leaf):
        if len(leaf.shape) != 2:
            if (len(leaf.shape) == 3 and tail in MOE_EXPERT_LEAVES
                    and leaf.scale.shape[0] == leaf.shape[0]):
                err = shard_error(leaf, n_shards, 0)
                return ("ep", None) if err is None else (None, err)
            return None, "non-matrix QTensor (fp-dequant einsum path)"
        err = shard_error(leaf, n_shards, axis % 2)
        return (mode, None) if err is None else (None, err)
    if getattr(leaf, "dtype", None) == torch.int8 and leaf.ndim == 2:
        dim = leaf.shape[axis]
        if dim % n_shards:
            return None, (f"dim {axis} ({dim}) not divisible by "
                          f"{n_shards} shards")
        return mode, None
    return None, None


def _to(leaf, dev: torch.device):
    """A contiguous copy of a leaf (or a shard view of one) on ``dev``;
    kernels then never copy it per call."""
    if is_qtensor(leaf):
        return QTensor(leaf.data.contiguous().to(dev),
                       leaf.scale.contiguous().to(dev), leaf.bits,
                       leaf.shape, leaf.axis)
    return leaf.contiguous().to(dev)


def shard_params(params, mesh, scales: Optional[Mapping] = None
                 ) -> Tuple[List[Dict], List[Dict[str, torch.Tensor]],
                            Dict[str, str]]:
    """Split a quantized parameter tree across ``mesh`` (a TPMesh).

    Column-parallel blocks split payload and scales along the output
    dim; row-parallel blocks along the reduction (pack) dim, where
    ``qtensor.shard_error`` keeps shard boundaries on whole pack units
    and whole scale groups; per-expert QTensor stacks along the expert
    dim. Everything else (fp leaves, blocks that fail alignment) is
    replicated, so the sharded engine gives the tp=1 tokens however
    much of the tree sharded.

    Returns ``(trees, shard_scales, plan)``: ``trees[i]`` and
    ``shard_scales[i]`` (the int8-backed path-keyed scales; channel-
    sliced for column blocks) live on ``mesh.devices[i]``; ``plan`` maps
    scoped block paths to "col" / "row" / "ep".
    """
    n = mesh.size
    plan: Dict[str, str] = {}
    parts: Dict[str, list] = {}
    split_axis = {"col": -1, "row": 0, "ep": 0}

    def place(name, leaf):
        mode, why = _plan_leaf(name, leaf, n)
        if mode is None:
            if why is not None:
                log.info("replicating %s: %s", name, why)
            pieces = [leaf] * n
        else:
            plan[qw_path(name)] = mode
            ax = split_axis[mode]
            pieces = (qt_shard(leaf, n, ax % len(leaf.shape))
                      if is_qtensor(leaf) else leaf.chunk(n, dim=ax))
        parts[name] = [_to(p, d) for p, d in zip(pieces, mesh.devices)]
        return leaf

    map_with_names(place, params)
    trees = [map_with_names(lambda name, _: parts[name][i], params)
             for i in range(n)]
    shard_scales: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    for key, s in (scales or {}).items():
        # int8-backed scales are (1, N): split the channel dim of column
        # blocks, replicate the rest (N stays whole on row blocks)
        pieces = (s.chunk(n, dim=-1)
                  if plan.get(key) == "col" and s.shape[-1] % n == 0
                  else [s] * n)
        for i, (p, d) in enumerate(zip(pieces, mesh.devices)):
            shard_scales[i][key] = p.contiguous().to(d)
    log.info("tp=%d sharded materialization: %d col, %d row, %d ep blocks",
             n, sum(1 for v in plan.values() if v == "col"),
             sum(1 for v in plan.values() if v == "row"),
             sum(1 for v in plan.values() if v == "ep"))
    return trees, shard_scales, plan


def sharded_storage_bytes(params, plan: Mapping[str, str],
                          n_shards: int) -> float:
    """PER-SHARD weight-storage bytes of a planned tree: sharded blocks
    cost 1/n of their payload and scales on each shard, replicated
    leaves their full size — what one shard's device holds."""
    total = 0.0
    for name, leaf in named_leaves(params):
        frac = 1.0 / n_shards if qw_path(name) in plan else 1.0
        total += frac * float(tree_payload_bytes(leaf))
    return total


def make_dequant_context(cfg: ModelConfig, scales=None,
                         int8_compute: bool = False,
                         moe_dispatch: str = "grouped") -> DequantContext:
    return DequantContext(dict(scales) if scales else {}, cfg.param_dtype,
                          int8_compute=int8_compute,
                          moe_dispatch=moe_dispatch)


def bit_config_from_report(report: SensitivityReport,
                           policy: Optional[QuantPolicy] = None,
                           avg_bits: float = 8.0) -> BitConfig:
    """FIT policy -> serving BitConfig: greedy knapsack at an average
    weight budget of ``avg_bits`` bits/param (activations left fp)."""
    policy = policy or QuantPolicy()
    total = sum(report.param_sizes.values())
    cfg = greedy_allocate(report, policy, budget_bits=avg_bits * total)
    return BitConfig(cfg.weight_bits, {})
