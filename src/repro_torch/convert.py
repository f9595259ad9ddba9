"""Parameter-tree conversion from the reference package's layout.

``params_from_numpy`` takes the reference's parameter tree after the
caller has turned every leaf into a numpy array (nested dicts keyed
``layers/<i>/attn/wq`` …, (K, N) matmul layout) and returns the port's
tree: the same keys and shapes, torch tensors on ``device``. Nothing is
transposed, and nothing of the reference is imported here.

``dtype`` recasts only the leaves the reference stores in the model
dtype: the ones it always keeps in fp32 (``FP32_LEAVES``, the MoE
router) stay fp32, as the port's own ``init_params`` makes them.

``bit_config_from_reference`` / ``draft_plan_from_reference`` carry a
reference ``BitConfig`` / ``DraftPlan`` across by their fields (so a
draft tree narrowed by the reference's plan can be narrowed by the port
from the same widths), and ``sampling_tables_from_numpy`` the engine's
per-slot sampling tables.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

# leaf names the reference initializes in fp32 whatever the model dtype
FP32_LEAVES = frozenset({"router"})


def _leaf(a: Any, device: torch.device, dtype: Optional[torch.dtype]):
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":      # ml_dtypes bf16: widen exactly
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Any, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Numpy parameter tree -> torch tree on ``device`` (default the GPU).
    ``dtype`` recasts the floating leaves stored in the model dtype (not
    ``FP32_LEAVES``)."""
    dev = resolve_device(device)

    def rec(node, key=None):
        if isinstance(node, dict):
            return {k: rec(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return _leaf(node, dev, None if key in FP32_LEAVES else dtype)

    return rec(tree)


def bit_config_from_reference(cfg: Any):
    """A reference ``BitConfig`` (any object with ``weight_bits`` and
    ``act_bits`` mappings) -> the port's ``BitConfig``."""
    from repro_torch.quant.policy import BitConfig
    return BitConfig({k: int(v) for k, v in cfg.weight_bits.items()},
                     {k: int(v) for k, v in cfg.act_bits.items()})


def draft_plan_from_reference(plan: Any):
    """A reference ``DraftPlan`` -> the port's, field by field."""
    from repro_torch.core.fit import DraftPlan
    return DraftPlan(bits=bit_config_from_reference(plan.bits),
                     kl_proxy=float(plan.kl_proxy),
                     accept_proxy=float(plan.accept_proxy),
                     avg_bits=float(plan.avg_bits))


# the engine's per-slot sampling tables and their dtypes
SAMPLING_TABLES = {"seeds": torch.int32, "temps": torch.float32,
                   "top_ks": torch.int32, "top_ps": torch.float32}


def sampling_tables_from_numpy(tables: Any, device: DeviceLike = None):
    """The reference engine's slot table (a mapping holding at least
    ``seeds``, ``temps``, ``top_ks`` and ``top_ps`` as arrays) -> the
    port engine's four (S,) tensors on ``device``, keyed alike."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(tables[k])).to(dt).to(dev)
            for k, dt in SAMPLING_TABLES.items()}
