"""Decoder-only LM (port of ``repro.models.transformer``):

  dense / audio / vlm : [attn + MLP] x L
  moe                 : [attn + MoE-FFN] x L
  ssm                 : [Mamba2 mixer] x L
  hybrid (Zamba2)     : groups of [the ONE shared attn/MLP block + period
                        x Mamba2], then the remainder's Mamba2 layers

Frontend stubs, as in the reference: the audio family consumes
multi-codebook token grids (B, S, CB) (EnCodec tokens; the codec itself
is out of scope) through one (V, D) embedding a codebook, summed, and a
(D, CB·V) head whose logits are (B, S, CB, V); the vlm family prepends
precomputed CLIP patch embeddings ``inputs["image_embed"]`` (B, T_img,
D), tapped as ``image_embed``, to the text embeddings.

Always the unrolled layout, the block paths FIT, the bit allocator and
the QTensor materializer key on: ``layers/<i>`` (dense, MoE, ssm); for
the hybrid ``shared`` (stored once), ``groups/<g>/<i>`` and ``rest/<i>``.
The forward scopes the shared block's g-th application ``shared/<g>``
(its activation taps are per application; its weight blocks are the one
``shared/...`` leaf). A MoE block holds a ``moe`` subtree in place of
``mlp``.

Where a gradient is taken (the FIT report's per-sample and tap
backwards, the Hessian probes, QAT), the blocks are rematerialized
(``cfg.remat``, the reference's checkpointed blocks): a block keeps its
input and recomputes its activations in the backward, so the report's
memory does not grow with the depth times the batch of its tap backward
(the SSD's (Q, Q, H) masks are ~7 MB a sample and a layer at Q = 128;
the vlm family's 704-position samples hold ~1 GB of fp32 attention
scores a layer for 4 samples). The numbers are those of the plain
forward. The attention blocks under QAT's per-layer contexts (training)
are not rematerialized.

QAT (``qat=QATLevels``) builds one ``QATContext`` per layer from the
per-layer levels tables, as the reference's stacked-layer forward does,
so the tables key on within-layer paths ("attn/wq", "mixer/wz"). The
hybrid's blocks run unquantized under QAT, as the reference's stacked
hybrid forward runs them; the embedding and head take the top tables.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch._device import DeviceLike, generator, resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.models.attention import (
    attention_apply, attention_decode, attention_decode_paged, init_attention)
from repro_torch.models.context import Context, QATContext
from repro_torch.models.layers import init_mlp, init_norm, mlp_apply, rmsnorm
from repro_torch.models.mamba2 import init_mamba2, mamba2_apply, mamba2_decode
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.partition import constrain

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def vocab_padded(cfg: ModelConfig, multiple: int = 16) -> int:
    v = cfg.vocab_size
    return ((v + multiple - 1) // multiple) * multiple


def require_known_family(cfg: ModelConfig) -> None:
    """Refuse a family the model does not know, with the reference's
    error type (its constructors raise ``ValueError(cfg.family)``)."""
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"unknown family {cfg.family!r} ({'|'.join(FAMILIES)})")


def _init_block(gen, cfg: ModelConfig, dtype, device) -> Dict:
    p = {"ln1": init_norm(cfg.d_model, dtype, device),
         "attn": init_attention(gen, cfg, dtype),
         "ln2": init_norm(cfg.d_model, dtype, device)}
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, cfg, dtype)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)
    return p


def _init_mamba_block(gen, cfg: ModelConfig, dtype, device) -> Dict:
    return {"ln": init_norm(cfg.d_model, dtype, device),
            "mixer": init_mamba2(gen, cfg, dtype)}


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict:
    """Seeded random parameters on ``device`` (default: the GPU). The
    numbers differ from the reference's init; tests that compare the
    two convert the reference's params with ``convert.params_from_numpy``."""
    require_known_family(cfg)
    dev = resolve_device(device)
    gen = generator(dev, seed)
    dtype = cfg.param_dtype
    v = vocab_padded(cfg)

    def emb(shape):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (x * 0.02).to(dtype)

    params: Dict = {"final_norm": init_norm(cfg.d_model, dtype, dev)}
    if cfg.family == "audio":
        params["embed"] = emb((cfg.num_codebooks, v, cfg.d_model))
        params["head"] = emb((cfg.d_model, cfg.num_codebooks * v))
    else:
        params["embed"] = emb((v, cfg.d_model))
        params["head"] = emb((cfg.d_model, v))
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        params["layers"] = {str(i): _init_block(gen, cfg, dtype, dev)
                            for i in range(cfg.num_layers)}
    elif cfg.family == "ssm":
        params["layers"] = {str(i): _init_mamba_block(gen, cfg, dtype, dev)
                            for i in range(cfg.num_layers)}
    else:
        n_groups, rest = divmod(cfg.num_layers, cfg.attn_period)
        params["shared"] = _init_block(gen, cfg, dtype, dev)
        params["groups"] = {
            str(g): {str(i): _init_mamba_block(gen, cfg, dtype, dev)
                     for i in range(cfg.attn_period)}
            for g in range(n_groups)}
        if rest:
            params["rest"] = {str(i): _init_mamba_block(gen, cfg, dtype, dev)
                              for i in range(rest)}
    return params


def _attn_mlp_block(x, bp, cfg: ModelConfig, ctx, positions=None):
    """One block -> (x, MoE aux loss; 0 for a dense block)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    with ctx.scope("attn"):
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        x = x + attention_apply(h, bp["attn"], cfg, ctx, positions)
    x = constrain(x, "batch", "seq", None)
    if cfg.family == "moe":
        with ctx.scope("moe"):
            h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
            y, aux = moe_apply(h, bp["moe"], cfg, ctx)
            x = x + y
    else:
        with ctx.scope("mlp"):
            h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
            x = x + mlp_apply(h, bp["mlp"], cfg.act, ctx)
    return constrain(x, "batch", "seq", None), aux


def _mamba_block(x, bp, cfg: ModelConfig, ctx):
    with ctx.scope("mixer"):
        h = rmsnorm(x, bp["ln"], cfg.norm_eps)
        x = x + mamba2_apply(h, bp["mixer"], cfg, ctx)
    return constrain(x, "batch", "seq", None)


def _mamba_block_decode(x, bp, cfg: ModelConfig, ctx, state):
    """One-token Mamba2 block; ``state`` (a ``MambaState``) is advanced in
    place."""
    with ctx.scope("mixer"):
        h = rmsnorm(x, bp["ln"], cfg.norm_eps)
        y, state = mamba2_decode(h, bp["mixer"], cfg, ctx, state)
        x = x + y
    return x, state


def _block(fn, x, bp, cfg: ModelConfig, ctx, scope: Optional[str]):
    """``fn(x, bp, cfg, ctx)`` under ``ctx.scope(scope)`` (None: no
    scope), rematerialized in the backward when a gradient is being
    taken and ``cfg.remat`` is set; the recompute runs under the scope
    stack the forward saw."""
    stack = list(ctx._scope)

    def run(h):
        with ctx.restored(stack):
            if scope is None:
                return fn(h, bp, cfg, ctx)
            with ctx.scope(scope):
                return fn(h, bp, cfg, ctx)

    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)
    return run(x)


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


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token ids (B, S) -> (B, S, D); the audio family's (B, S, CB) grids
    sum one embedding a codebook, from zero and in codebook order, in the
    param dtype (the reference's order of additions)."""
    tokens = tokens.long()
    if cfg.family != "audio":
        return params["embed"][tokens]
    emb = params["embed"]
    x = torch.zeros(tokens.shape[:2] + (cfg.d_model,), dtype=emb.dtype,
                    device=emb.device)
    for cb in range(cfg.num_codebooks):
        x = x + emb[cb][tokens[..., cb]]
    return x


def embed_inputs(params, inputs: Dict[str, torch.Tensor], cfg: ModelConfig,
                 ctx) -> torch.Tensor:
    """Token/frontend embedding -> (B, S, D); the vlm family's image
    patches come first."""
    x = embed_tokens(params, inputs["tokens"], cfg)
    if cfg.family == "vlm":
        img = ctx.tap("image_embed", inputs["image_embed"].to(x.dtype))
        x = torch.cat([img, x], dim=1)
    return constrain(ctx.tap("embed_out", x), "batch", "seq", None)


def split_codebooks(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The audio head's (B, S, CB·V) logits -> (B, S, CB, V); other
    families' logits as they are."""
    if cfg.family != "audio":
        return logits
    b, s, _ = logits.shape
    return logits.reshape(b, s, cfg.num_codebooks, vocab_padded(cfg))


def logits_from_hidden(params, x, cfg: ModelConfig, ctx) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = split_codebooks(ctx.matmul("head", x, params["head"]), cfg)
    return constrain(logits, "batch", None, *(None,) * (logits.ndim - 3), "vocab")


def forward(params, inputs: Dict[str, torch.Tensor], cfg: ModelConfig,
            ctx: Optional[Context] = None, qat: Optional[QATLevels] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, S, V_padded) — (B, S, CB, V_padded) for audio —, MoE
    aux loss summed over layers) of the unrolled forward. ``ctx`` runs every layer under its block scope
    (``layers/<i>``; the hybrid's ``shared/<g>``, ``groups/<g>/<i>``,
    ``rest/<i>``); otherwise ``qat`` gives each layer its own
    ``QATContext`` (no ``qat``: the plain forward)."""
    require_known_family(cfg)
    layer_ctx = None
    if ctx is None and qat is not None:
        ctx = QATContext(qat.top_weights, qat.top_acts)
        layer_ctx = lambda i: QATContext(  # noqa: E731
            {k: v[i] for k, v in qat.layer_weights.items()},
            {k: v[i] for k, v in qat.layer_acts.items()})
    ctx = ctx or Context()
    x = embed_inputs(params, inputs, cfg, ctx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        # under QAT the hybrid's blocks run unquantized (layer_ctx set)
        bctx = Context() if layer_ctx is not None else ctx
        n_groups, rest = divmod(cfg.num_layers, cfg.attn_period)
        for g in range(n_groups):
            x, da = _block(_attn_mlp_block, x, params["shared"], cfg, bctx,
                           f"shared/{g}")
            aux = aux + da
            for i in range(cfg.attn_period):
                x = _block(_mamba_block, x, params["groups"][str(g)][str(i)],
                           cfg, bctx, f"groups/{g}/{i}")
        for i in range(rest):
            x = _block(_mamba_block, x, params["rest"][str(i)], cfg, bctx,
                       f"rest/{i}")
        return logits_from_hidden(params, x, cfg, ctx), aux
    if cfg.family == "ssm":
        for i in range(cfg.num_layers):
            bp = params["layers"][str(i)]
            x = (_block(_mamba_block, x, bp, cfg, layer_ctx(i), None)
                 if layer_ctx is not None else
                 _block(_mamba_block, x, bp, cfg, ctx, f"layers/{i}"))
        return logits_from_hidden(params, x, cfg, ctx), aux
    for i in range(cfg.num_layers):
        bp = params["layers"][str(i)]
        if layer_ctx is not None:
            x, da = _attn_mlp_block(x, bp, cfg, layer_ctx(i))
        else:
            x, da = _block(_attn_mlp_block, x, bp, cfg, ctx, f"layers/{i}")
        aux = aux + da
    return logits_from_hidden(params, x, cfg, ctx), aux


def loss_fn(params, inputs: Dict[str, torch.Tensor], cfg: ModelConfig,
            ctx: Optional[Context] = None, qat: Optional[QATLevels] = None,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token cross-entropy plus ``aux_weight`` times the MoE
    aux loss (audio: over every (position, codebook) label of the
    (B, S, CB) grid); the padded vocab is masked. The CE stays in the logits
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
