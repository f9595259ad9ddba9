"""The paper's small convolutional classifier (Appendix D, Fig. 8; port of
``repro.models.cnn``).

Three conv blocks (conv → [BN] → ReLU, the first two followed by a 2×2
max-pool) plus a fully-connected head: the testbed of experiments A–D.
Functional over a nested param dict with the same ``ctx.qw`` /
``ctx.tap`` hooks as the LM zoo, so FIT, QAT and the heuristic baselines
apply unchanged.

The reference's layouts are kept: NHWC activations and HWIO conv weights
(3, 3, C_in, C_out), so ``convert.params_from_numpy`` maps its trees 1:1
and the report's block paths (``conv<i>/w``, ``fc/w``, ``fc/b``,
``bn<i>/gamma|beta``), ``param_sizes`` and tap sites (``act<i>``) equal
the reference's. The convolution runs as ``F.conv2d`` on NCHW/OIHW
views ("SAME" at 3×3, stride 1: padding 1), as the reference runs its
convolution outside any Pallas kernel. Batch-norm normalizes with the
batch's own statistics over (B, H, W), as the reference's ``_bn`` does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, generator, resolve_device
from repro_torch.models.context import CollectContext, Context, TapContext


def init_cnn(seed: int = 0, num_classes: int = 10, channels: int = 3,
             filters: int = 16, input_hw: int = 16, batchnorm: bool = True,
             device: DeviceLike = None) -> Dict:
    """Seeded fp32 parameters on ``device`` (default: the GPU): He-scaled
    HWIO conv weights, a (hw·hw·2F, classes) head at 0.05, zero bias,
    unit BN scales. The numbers differ from the reference's init; tests
    convert the reference's params with ``convert.params_from_numpy``."""
    dev = resolve_device(device)
    gen = generator(dev, seed)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    def conv(cin, cout):
        return randn((3, 3, cin, cout)) * math.sqrt(2.0 / (9 * cin))

    p = {"conv1": {"w": conv(channels, filters)},
         "conv2": {"w": conv(filters, 2 * filters)},
         "conv3": {"w": conv(2 * filters, 2 * filters)}}
    hw = input_hw // 4                       # two 2x2 maxpools
    p["fc"] = {"w": randn((hw * hw * 2 * filters, num_classes)) * 0.05,
               "b": torch.zeros((num_classes,), dtype=torch.float32, device=dev)}
    if batchnorm:
        for i, c in (("1", filters), ("2", 2 * filters), ("3", 2 * filters)):
            p[f"bn{i}"] = {"gamma": torch.ones((c,), device=dev),
                           "beta": torch.zeros((c,), device=dev)}
    return p


def _conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC x HWIO -> NHWC, stride 1, "SAME" padding (3×3: 1 a side)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=w.shape[0] // 2)
    return y.permute(0, 2, 3, 1)


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """2×2 max-pool, stride 2, "VALID", over NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _bn(x: torch.Tensor, p: Dict, eps: float = 1e-5) -> torch.Tensor:
    """Batch-norm with the batch's statistics over (B, H, W) (population
    variance)."""
    mu = torch.mean(x, dim=(0, 1, 2), keepdim=True)
    var = torch.var(x, dim=(0, 1, 2), unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["gamma"] + p["beta"]


def cnn_forward(params: Dict, x: torch.Tensor,
                ctx: Optional[Context] = None) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, num_classes)."""
    ctx = ctx or Context()
    bn = "bn1" in params

    def block(x, i, pool):
        with ctx.scope(f"conv{i}"):
            h = _conv2d(x, ctx.qw("w", params[f"conv{i}"]["w"]))
        if bn:
            h = _bn(h, params[f"bn{i}"])
        h = torch.relu(h)
        h = ctx.tap(f"act{i}", h)
        return _maxpool(h) if pool else h

    h = block(x, 1, True)
    h = block(h, 2, True)
    h = block(h, 3, False)
    h = h.reshape(h.shape[0], -1)
    with ctx.scope("fc"):
        return h @ ctx.qw("w", params["fc"]["w"]) + params["fc"]["b"]


def cnn_loss(params: Dict, batch: Tuple[torch.Tensor, torch.Tensor],
             ctx: Optional[Context] = None) -> torch.Tensor:
    x, y = batch
    lp = torch.log_softmax(cnn_forward(params, x, ctx), dim=-1)
    return -torch.mean(torch.gather(lp, -1, y.long()[:, None]))


def cnn_accuracy(params: Dict, x: torch.Tensor, y: torch.Tensor) -> float:
    with torch.no_grad():
        logits = cnn_forward(params, x)
    return float(torch.mean((torch.argmax(logits, -1) == y.long())
                            .to(torch.float32)))


def cnn_tap_shapes(params: Dict, batch, batchnorm: bool = True) -> Dict:
    """{site: (shape, dtype)} of the three activation taps."""
    x, _ = batch
    b, hw = x.shape[0], x.shape[1]
    f = params["conv1"]["w"].shape[-1]
    return {"act1": ((b, hw, hw, f), torch.float32),
            "act2": ((b, hw // 2, hw // 2, 2 * f), torch.float32),
            "act3": ((b, hw // 4, hw // 4, 2 * f), torch.float32)}


def cnn_tap_loss(params: Dict, taps, batch) -> torch.Tensor:
    return cnn_loss(params, batch, ctx=_TapCtx(taps))


# the reference's name for the context that adds each tap at its site
_TapCtx = TapContext


def cnn_act_fn(params: Dict, batch) -> Dict:
    ctx = CollectContext()
    cnn_loss(params, batch, ctx=ctx)
    return ctx.acts
