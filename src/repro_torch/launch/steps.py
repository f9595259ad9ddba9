"""The training step (port of the train-step part of
``repro.launch.steps``): QAT levels tables, the train state, and one
step of loss → backward → AdamW. One device, no mesh, no sharding rules.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models.transformer import (
    QATLevels, loss_fn, require_known_family)
from repro_torch.optim.adamw import AdamState, AdamWConfig, adamw_update
from repro_torch.quant.policy import BitConfig
from repro_torch.utils.pytree import map_with_names, named_leaves

OFF = 65535.0          # levels sentinel: the block stays unquantized


class TrainState(NamedTuple):
    params: Any
    opt: AdamState


def bitconfig_to_levels(cfg: ModelConfig, bits: BitConfig,
                        device: DeviceLike = None) -> QATLevels:
    """BitConfig (block path -> bits) to per-layer levels tables.

    Paths "layers/<i>/<rest>" become (L,) tensors keyed "<rest>"; other
    blocks stay scalars. A block missing from a layer's table is not
    quantized there (levels 2^16 − 1)."""
    dev = resolve_device(device)
    lw: Dict[str, np.ndarray] = {}
    la: Dict[str, np.ndarray] = {}
    tw: Dict[str, torch.Tensor] = {}
    ta: Dict[str, torch.Tensor] = {}

    def insert(table_layer, table_top, path, b):
        parts = path.split("/")
        lv = float(2 ** b - 1) if b < 16 else OFF
        if parts[0] == "layers" and len(parts) >= 3 and parts[1].isdigit():
            key = "/".join(parts[2:])
            arr = table_layer.setdefault(key, np.full(cfg.num_layers, OFF,
                                                      np.float32))
            arr[int(parts[1])] = lv
        else:
            table_top[path] = torch.tensor(lv, dtype=torch.float32, device=dev)

    for path, b in bits.weight_bits.items():
        insert(lw, tw, path, b)
    for path, b in bits.act_bits.items():
        insert(la, ta, path, b)
    return QATLevels({k: torch.from_numpy(v).to(dev) for k, v in lw.items()},
                     {k: torch.from_numpy(v).to(dev) for k, v in la.items()},
                     tw, ta)


def uniform_levels(cfg: ModelConfig, weight_bits: int,
                   act_bits: Optional[int], device: DeviceLike = None
                   ) -> QATLevels:
    """Uniform QAT levels over the standard per-layer blocks: every
    attention and MLP (or expert, or Mamba2 projection but ``wdt``) weight
    at ``weight_bits``; the attention output and the MLP hidden
    activation (the Mamba2 conv and SSD outputs) at ``act_bits`` (None:
    none). The audio and vlm families take the dense family's blocks. The
    hybrid gets empty tables: its blocks run unquantized under QAT, as in
    the reference."""
    require_known_family(cfg)
    dev = resolve_device(device)
    if cfg.family == "moe":
        wkeys = ["attn/wq", "attn/wk", "attn/wv", "attn/wo",
                 "moe/w_up", "moe/w_gate", "moe/w_down"]
        akeys = ["attn/attn_out", "moe/moe_h"]
    elif cfg.family == "ssm":
        wkeys = ["mixer/wz", "mixer/wx", "mixer/wB", "mixer/wC",
                 "mixer/out_proj"]
        akeys = ["mixer/conv_out", "mixer/ssd_out"]
    elif cfg.family == "hybrid":
        wkeys, akeys = [], []
    else:
        wkeys = ["attn/wq", "attn/wk", "attn/wv", "attn/wo",
                 "mlp/w_up", "mlp/w_down"] + (
                     ["mlp/w_gate"] if cfg.act == "swiglu" else [])
        akeys = ["attn/attn_out", "mlp/mlp_h"]
    ones = torch.ones((cfg.num_layers,), dtype=torch.float32, device=dev)
    lw = {k: ones * float(2 ** weight_bits - 1) for k in wkeys}
    la = {}
    if act_bits is not None:
        la = {k: ones * float(2 ** act_bits - 1) for k in akeys}
    return QATLevels(lw, la, {}, {})


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def train_step(state: TrainState, batch: Dict[str, Any], cfg: ModelConfig,
               adam: AdamWConfig, qat: Optional[QATLevels] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """loss_fn → backward → adamw_update. The params must require grad;
    they and the moments are updated in place. Metrics stay on the
    device: loss, lr, grad_norm."""
    leaves = named_leaves(state.params)
    loss = loss_fn(state.params, batch, cfg, qat=qat)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    by_name = {name: g for (name, _), g in zip(leaves, grads)}
    del grads
    gtree = map_with_names(lambda name, _: by_name[name], state.params)
    params, opt, metrics = adamw_update(adam, state.params, gtree, state.opt)
    return TrainState(params, opt), {"loss": loss.detach(), **metrics}
