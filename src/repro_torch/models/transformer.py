"""Decoder-only LM, dense family (port of ``repro.models.transformer``).

Always the unrolled layout: one parameter subtree per layer under
``layers/<i>``, the block paths FIT, the bit allocator and the QTensor
materializer key on. The MoE, ssm, hybrid, audio and vlm families are
not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch._device import DeviceLike, generator, resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models.attention import (
    attention_apply, attention_decode, attention_decode_paged, init_attention)
from repro_torch.models.context import Context
from repro_torch.models.layers import init_mlp, init_norm, mlp_apply, rmsnorm


def vocab_padded(cfg: ModelConfig, multiple: int = 16) -> int:
    v = cfg.vocab_size
    return ((v + multiple - 1) // multiple) * multiple


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")


def _init_block(gen, cfg: ModelConfig, dtype, device) -> Dict:
    return {"ln1": init_norm(cfg.d_model, dtype, device),
            "attn": init_attention(gen, cfg, dtype),
            "ln2": init_norm(cfg.d_model, dtype, device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)}


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict:
    """Seeded random parameters on ``device`` (default: the GPU). The
    numbers differ from the reference's init; tests that compare the
    two convert the reference's params with ``convert.params_from_numpy``."""
    require_dense(cfg)
    dev = resolve_device(device)
    gen = generator(dev, seed)
    dtype = cfg.param_dtype
    v = vocab_padded(cfg)

    def emb(shape):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (x * 0.02).to(dtype)

    params: Dict = {"final_norm": init_norm(cfg.d_model, dtype, dev),
                    "embed": emb((v, cfg.d_model)),
                    "head": emb((cfg.d_model, v))}
    params["layers"] = {str(i): _init_block(gen, cfg, dtype, dev)
                        for i in range(cfg.num_layers)}
    return params


def _attn_mlp_block(x, bp, cfg: ModelConfig, ctx, positions=None):
    with ctx.scope("attn"):
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        x = x + attention_apply(h, bp["attn"], cfg, ctx, positions)
    with ctx.scope("mlp"):
        h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
        x = x + mlp_apply(h, bp["mlp"], cfg.act, ctx)
    return x


def _decode_block(x, bp, cfg, ctx, attn):
    """Decode-block skeleton shared by the dense- and paged-cache paths:
    ``attn(h)`` runs the attention step and returns (output, state)."""
    with ctx.scope("attn"):
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        a, st = attn(h)
        x = x + a
    with ctx.scope("mlp"):
        h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
        x = x + mlp_apply(h, bp["mlp"], cfg.act, ctx)
    return x, st


def _attn_mlp_block_decode(x, bp, cfg, ctx, cache, pos):
    return _decode_block(
        x, bp, cfg, ctx,
        lambda h: attention_decode(h, bp["attn"], cfg, ctx, cache, pos))


def _attn_mlp_block_decode_paged(x, bp, cfg, ctx, lp, table, pos, write_limit):
    return _decode_block(
        x, bp, cfg, ctx,
        lambda h: attention_decode_paged(h, bp["attn"], cfg, ctx, lp, table,
                                         pos, write_limit))


def embed_inputs(params, inputs: Dict[str, torch.Tensor], cfg: ModelConfig,
                 ctx) -> torch.Tensor:
    x = params["embed"][inputs["tokens"].long()]
    return ctx.tap("embed_out", x)


def logits_from_hidden(params, x, cfg: ModelConfig, ctx) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return ctx.matmul("head", x, params["head"])


def forward(params, inputs: Dict[str, torch.Tensor], cfg: ModelConfig,
            ctx: Optional[Context] = None) -> torch.Tensor:
    """Logits (B, S, V_padded) of the unrolled forward."""
    require_dense(cfg)
    ctx = ctx or Context()
    x = embed_inputs(params, inputs, cfg, ctx)
    for i in range(cfg.num_layers):
        with ctx.scope(f"layers/{i}"):
            x = _attn_mlp_block(x, params["layers"][str(i)], cfg, ctx)
    return logits_from_hidden(params, x, cfg, ctx)


def loss_fn(params, inputs: Dict[str, torch.Tensor], cfg: ModelConfig,
            ctx: Optional[Context] = None) -> torch.Tensor:
    """Mean next-token cross-entropy; the padded vocab is masked. The CE
    stays in the logits dtype, with fp32 only inside exp and the sum."""
    logits = forward(params, inputs, cfg, ctx=ctx)
    labels = inputs["labels"].long()
    v = vocab_padded(cfg)
    if v != cfg.vocab_size:
        iota = torch.arange(v, device=logits.device)
        mask = torch.where(iota < cfg.vocab_size, 0.0, -1e9).to(logits.dtype)
        logits = logits + mask
    m = torch.amax(logits, dim=-1, keepdim=True)
    shifted = logits - m.detach()
    sumexp = torch.sum(torch.exp(shifted.to(torch.float32)), dim=-1)
    gold = torch.gather(shifted, -1, labels[..., None])[..., 0]
    nll = torch.log(sumexp) - gold.to(torch.float32)
    return torch.mean(nll)
