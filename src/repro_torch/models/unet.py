"""Small U-Net (the paper's Sec. 4.3 semantic-segmentation study, scaled
down; port of ``repro.models.unet``).

Encoder (2 down blocks) → bottleneck → decoder (2 up blocks: nearest 2×
upsampling, a conv, then the skip concatenated on the channel axis) →
per-pixel classifier. NHWC activations and HWIO weights with the same
ctx hooks as ``models.cnn``, so the FIT pipeline applies unchanged and
the block paths and tap sites (``<block>_act``) equal the reference's.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, generator, resolve_device
from repro_torch.models.cnn import _TapCtx, _conv2d, _maxpool
from repro_torch.models.context import CollectContext, Context


def init_unet(seed: int = 0, num_classes: int = 4, channels: int = 3,
              base: int = 8, device: DeviceLike = None) -> Dict:
    """Seeded fp32 He-scaled HWIO conv weights on ``device`` (default:
    the GPU); the numbers differ from the reference's init."""
    dev = resolve_device(device)
    gen = generator(dev, seed)

    def conv(cin, cout):
        return {"w": torch.randn((3, 3, cin, cout), generator=gen, device=dev,
                                 dtype=torch.float32) * math.sqrt(2.0 / (9 * cin))}

    return {"enc1": conv(channels, base), "enc2": conv(base, 2 * base),
            "mid": conv(2 * base, 4 * base), "up2": conv(4 * base, 2 * base),
            "dec2": conv(4 * base, 2 * base), "up1": conv(2 * base, base),
            "dec1": conv(2 * base, base), "head": conv(base, num_classes)}


def _upsample(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsampling of NHWC: each pixel repeated 2×2."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def unet_forward(params: Dict, x: torch.Tensor,
                 ctx: Optional[Context] = None) -> torch.Tensor:
    """x: (B, H, W, C) -> per-pixel logits (B, H, W, num_classes)."""
    ctx = ctx or Context()

    def conv(name, h):
        with ctx.scope(name):
            h = _conv2d(h, ctx.qw("w", params[name]["w"]))
        h = torch.relu(h)
        return ctx.tap(f"{name}_act", h)

    e1 = conv("enc1", x)                       # (B, H, W, b)
    e2 = conv("enc2", _maxpool(e1))            # (B, H/2, W/2, 2b)
    m = conv("mid", _maxpool(e2))              # (B, H/4, W/4, 4b)
    d2 = conv("up2", _upsample(m))             # (B, H/2, W/2, 2b)
    d2 = conv("dec2", torch.cat([d2, e2], -1))
    d1 = conv("up1", _upsample(d2))
    d1 = conv("dec1", torch.cat([d1, e1], -1))
    with ctx.scope("head"):
        return _conv2d(d1, ctx.qw("w", params["head"]["w"]))


def unet_loss(params: Dict, batch: Tuple[torch.Tensor, torch.Tensor],
              ctx: Optional[Context] = None) -> torch.Tensor:
    x, y = batch
    lp = torch.log_softmax(unet_forward(params, x, ctx), dim=-1)
    return -torch.mean(torch.gather(lp, -1, y.long()[..., None]))


def unet_miou(params: Dict, x: torch.Tensor, y: torch.Tensor,
              num_classes: int = 4) -> float:
    """Mean IoU over the classes; a class absent from both the
    prediction and the labels counts 1."""
    with torch.no_grad():
        pred = torch.argmax(unet_forward(params, x), -1)
    y = y.long()
    ious = []
    for c in range(num_classes):
        inter = torch.sum((pred == c) & (y == c)).to(torch.float32)
        union = torch.sum((pred == c) | (y == c)).to(torch.float32)
        ious.append(torch.where(union > 0, inter / union,
                                torch.ones_like(union)))
    return float(torch.mean(torch.stack(ious)))


def unet_tap_loss(params, taps, batch):
    return unet_loss(params, batch, ctx=_TapCtx(taps))


def unet_tap_shapes(params: Dict, batch) -> Dict:
    """{site: (shape, dtype)} of the seven activation taps."""
    x, _ = batch
    b, hw = x.shape[0], x.shape[1]
    base = params["enc1"]["w"].shape[-1]
    f32 = torch.float32
    return {"enc1_act": ((b, hw, hw, base), f32),
            "enc2_act": ((b, hw // 2, hw // 2, 2 * base), f32),
            "mid_act": ((b, hw // 4, hw // 4, 4 * base), f32),
            "up2_act": ((b, hw // 2, hw // 2, 2 * base), f32),
            "dec2_act": ((b, hw // 2, hw // 2, 2 * base), f32),
            "up1_act": ((b, hw, hw, base), f32),
            "dec1_act": ((b, hw, hw, base), f32)}


def unet_act_fn(params: Dict, batch) -> Dict:
    ctx = CollectContext()
    unet_loss(params, batch, ctx=ctx)
    return ctx.acts
