"""Decoder-only LM, dense and MoE families (port of
``repro.models.transformer``).

Always the unrolled layout: one parameter subtree per layer under
``layers/<i>``, the block paths FIT, the bit allocator and the QTensor
materializer key on. A MoE block holds a ``moe`` subtree in place of
``mlp``. The ssm, hybrid, audio and vlm families are not ported yet.

QAT (``qat=QATLevels``) builds one ``QATContext`` per layer from the
per-layer levels tables, as the reference's stacked-layer forward does,
so the tables key on within-layer paths ("attn/wq").
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, generator, resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models.attention import (
    attention_apply, attention_decode, attention_decode_paged, init_attention)
from repro_torch.models.context import Context, QATContext
from repro_torch.models.layers import init_mlp, init_norm, mlp_apply, rmsnorm
from repro_torch.models.moe import init_moe, moe_apply

FAMILIES = ("dense", "moe")


def vocab_padded(cfg: ModelConfig, multiple: int = 16) -> int:
    v = cfg.vocab_size
    return ((v + multiple - 1) // multiple) * multiple


def require_ported_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet ({'|'.join(FAMILIES)})")


def _init_block(gen, cfg: ModelConfig, dtype, device) -> Dict:
    p = {"ln1": init_norm(cfg.d_model, dtype, device),
         "attn": init_attention(gen, cfg, dtype),
         "ln2": init_norm(cfg.d_model, dtype, device)}
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)
    return p


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict:
    """Seeded random parameters on ``device`` (default: the GPU). The
    numbers differ from the reference's init; tests that compare the
    two convert the reference's params with ``convert.params_from_numpy``."""
    require_ported_family(cfg)
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
    """One block -> (x, MoE aux loss; 0 for a dense block)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    with ctx.scope("attn"):
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        x = x + attention_apply(h, bp["attn"], cfg, ctx, positions)
    if cfg.family == "moe":
        with ctx.scope("moe"):
            h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
            y, aux = moe_apply(h, bp["moe"], cfg, ctx)
            x = x + y
    else:
        with ctx.scope("mlp"):
            h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
            x = x + mlp_apply(h, bp["mlp"], cfg.act, ctx)
    return x, aux


def column_rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """``rmsnorm`` of (B, T, D) decode columns, one call a column when
    T > 1: a device's row reduction may split its sum by the row count,
    and each column must keep a one-token step's bits."""
    if x.shape[1] == 1:
        return rmsnorm(x, gamma, eps)
    return torch.cat([rmsnorm(x[:, j:j + 1].contiguous(), gamma, eps)
                      for j in range(x.shape[1])], dim=1)


def _decode_block(x, bp, cfg, ctx, attn):
    """Decode-block skeleton shared by the dense- and paged-cache paths:
    ``attn(h)`` runs the attention step and returns (output, state). A
    (B, T) call gives each column the bits of a one-token step (see
    ``models.decode.decode_step``)."""
    with ctx.scope("attn"):
        h = column_rmsnorm(x, bp["ln1"], cfg.norm_eps)
        a, st = attn(h)
        x = x + a
    if cfg.family == "moe":
        with ctx.scope("moe"):
            h = column_rmsnorm(x, bp["ln2"], cfg.norm_eps)
            if h.shape[1] > 1:
                # capacity and rank depend on the call's token count, so
                # each query column is routed on its own: a (B, T) call
                # equals T one-token steps even when experts overflow
                y = torch.cat([moe_apply(h[:, j:j + 1].contiguous(), bp["moe"],
                                         cfg, ctx)[0]
                               for j in range(h.shape[1])], dim=1)
            else:
                y, _ = moe_apply(h, bp["moe"], cfg, ctx)
            x = x + y
    else:
        with ctx.scope("mlp"):
            h = column_rmsnorm(x, bp["ln2"], cfg.norm_eps)
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


class QATLevels(NamedTuple):
    """levels = 2^bits − 1 per block path.

    ``layer_weights``/``layer_acts`` hold (L,) tensors keyed by the
    within-layer path ("attn/wq"); ``top_weights``/``top_acts`` hold
    scalars for the embedding and the head. Levels >= 32767 leave a
    block unquantized."""
    layer_weights: Dict[str, torch.Tensor]
    layer_acts: Dict[str, torch.Tensor]
    top_weights: Dict[str, torch.Tensor]
    top_acts: Dict[str, torch.Tensor]


def embed_inputs(params, inputs: Dict[str, torch.Tensor], cfg: ModelConfig,
                 ctx) -> torch.Tensor:
    x = params["embed"][inputs["tokens"].long()]
    return ctx.tap("embed_out", x)


def logits_from_hidden(params, x, cfg: ModelConfig, ctx) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return ctx.matmul("head", x, params["head"])


def forward(params, inputs: Dict[str, torch.Tensor], cfg: ModelConfig,
            ctx: Optional[Context] = None, qat: Optional[QATLevels] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, S, V_padded), MoE aux loss summed over layers) of the
    unrolled forward. ``ctx`` runs every layer under ``layers/<i>``
    scopes; otherwise ``qat`` gives each layer its own ``QATContext``
    (no ``qat``: the plain forward)."""
    require_ported_family(cfg)
    layer_ctx = None
    if ctx is None and qat is not None:
        ctx = QATContext(qat.top_weights, qat.top_acts)
        layer_ctx = lambda i: QATContext(  # noqa: E731
            {k: v[i] for k, v in qat.layer_weights.items()},
            {k: v[i] for k, v in qat.layer_acts.items()})
    ctx = ctx or Context()
    x = embed_inputs(params, inputs, cfg, ctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        bp = params["layers"][str(i)]
        if layer_ctx is not None:
            x, da = _attn_mlp_block(x, bp, cfg, layer_ctx(i))
        else:
            with ctx.scope(f"layers/{i}"):
                x, da = _attn_mlp_block(x, bp, cfg, ctx)
        aux = aux + da
    return logits_from_hidden(params, x, cfg, ctx), aux


def loss_fn(params, inputs: Dict[str, torch.Tensor], cfg: ModelConfig,
            ctx: Optional[Context] = None, qat: Optional[QATLevels] = None,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token cross-entropy plus ``aux_weight`` times the MoE
    aux loss; the padded vocab is masked. The CE stays in the logits
    dtype, with fp32 only inside exp and the sum."""
    logits, aux = forward(params, inputs, cfg, ctx=ctx, qat=qat)
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
    return torch.mean(nll) + aux_weight * aux
