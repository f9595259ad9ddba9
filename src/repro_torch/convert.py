"""Parameter-tree conversion from the reference package's layout.

``params_from_numpy`` takes the reference's parameter tree after the
caller has turned every leaf into a numpy array (nested dicts keyed
``layers/<i>/attn/wq`` …, (K, N) matmul layout) and returns the port's
tree: the same keys and shapes, torch tensors on ``device``. Nothing is
transposed, and nothing of the reference is imported here.

``dtype`` recasts only the leaves the reference stores in the model
dtype: the ones it always keeps in fp32 (``FP32_LEAVES``, the MoE
router) stay fp32, as the port's own ``init_params`` makes them.
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
