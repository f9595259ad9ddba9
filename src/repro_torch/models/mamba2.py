"""Mamba2 blocks (SSD, state-space duality) in PyTorch (port of
``repro.models.mamba2``).

Chunked SSD (arXiv:2405.21060, Listing 1): an intra-chunk quadratic,
attention-like term over (Q x Q) blocks plus an inter-chunk linear state
recurrence over the chunks. The decay arithmetic stays fp32; decays are
exp of non-positive numbers, so everything is <= 1.

Recurrence (per head; state (N, P)):
    h_t = exp(dt_t·A) h_{t−1} + dt_t·(B_t ⊗ x_t)
    y_t = C_t·h_t + D·x_t

Decode applies the recurrence once a token, O(1) in the context. The
port's decode writes the state IN PLACE (as its KV caches): the SSM state
h and the conv tail of every row it advances.

No CUDA kernel here: the reference runs the scan and the depthwise conv
as plain array code outside any Pallas kernel, so they are plain
PyTorch (einsum/matmul and ``F.conv1d``); the five projections go
through ``ctx.matmul`` (``qmm`` on packed serving).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models.layers import grad_barrier, init_dense, rmsnorm


def _conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    """Separate segment matrices (z | x | B | C | dt) rather than one
    fused (D, 2di+2gn+h) matrix, as the reference stores them: each
    segment shards on its own under tensor parallelism. The conv and the
    SSM vectors are fp32 whatever the model dtype."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    n, g, w = cfg.ssm_state, cfg.ssm_groups, cfg.conv_width
    cc = _conv_channels(cfg)
    dev = gen.device

    def vec(shape, val=None):
        if val is not None:
            return torch.full(shape, val, dtype=torch.float32, device=dev)
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * 0.02

    return {
        "wz": init_dense(gen, d, di, dtype),
        "wx": init_dense(gen, d, di, dtype),
        "wB": init_dense(gen, d, g * n, dtype),
        "wC": init_dense(gen, d, g * n, dtype),
        "wdt": init_dense(gen, d, h, dtype),
        "conv_w": vec((w, cc)),
        "conv_b": vec((cc,), 0.0),
        "A_log": vec((h,), 0.0),          # A = −exp(A_log) = −1 at init
        "D": vec((h,), 1.0),
        "dt_bias": vec((h,), 0.0),
        "norm_w": vec((di,), 1.0),
        "out_proj": init_dense(gen, di, d, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (W, C) -> (B, S, C): one
    depthwise convolution over x left-padded by W − 1, in x's dtype; the
    bias is added in fp32."""
    width, c = w.shape
    xp = F.pad(x.transpose(1, 2), (width - 1, 0))            # (B, C, S+W-1)
    out = F.conv1d(xp, w.t().reshape(c, 1, width).to(x.dtype), groups=c)
    return (out.transpose(1, 2) + b.to(torch.float32)).to(x.dtype)


def _project_in(x: torch.Tensor, prm: Dict, ctx):
    """x -> (z, xs, B, C, dt) through the split segment projections."""
    z = grad_barrier(ctx.matmul("wz", x, prm["wz"]))
    xs = grad_barrier(ctx.matmul("wx", x, prm["wx"]))
    Bm = grad_barrier(ctx.matmul("wB", x, prm["wB"]))
    Cm = grad_barrier(ctx.matmul("wC", x, prm["wC"]))
    dt = grad_barrier(ctx.matmul("wdt", x, prm["wdt"]))
    return z, xs, Bm, Cm, dt


def _conv_slices(cfg: ModelConfig):
    di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    return (0, di), (di, di + gn), (di + gn, di + 2 * gn)


def _in(t: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """An einsum operand rounded to the compute dtype and read as fp32:
    products of cd values accumulated in fp32, as the reference's
    ``preferred_element_type=float32`` contractions."""
    return t.to(cd).to(torch.float32)


def ssd_chunked(xs: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h_init: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xs: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) negative;
    Bm, Cm: (B, S, N) (one group, broadcast over heads). A sequence that
    is not a multiple of the chunk is zero-padded (dt = 0 there: the pad
    neither decays nor feeds the state). Returns (y (B, S, H, P) in xs's
    dtype, the final state (B, H, N, P) fp32)."""
    b, s, h, p = xs.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))

    xs_c = xs.reshape(b, nc, q, h, p)
    dt_c = dt.reshape(b, nc, q, h).to(torch.float32)
    B_c = Bm.reshape(b, nc, q, n).to(torch.float32)
    C_c = Cm.reshape(b, nc, q, n).to(torch.float32)

    dA = dt_c * A                                      # (B,c,Q,H), <= 0
    cum = torch.cumsum(dA, dim=2)                      # inclusive

    # intra-chunk (quadratic, block-diagonal): the decays stay fp32; the
    # (B,c,Q,Q,H) mask and its contraction run in ``compute_dtype``
    cd = compute_dtype
    li = cum[:, :, :, None, :]                         # (B,c,Q,1,H): i
    lj = cum[:, :, None, :, :]                         # (B,c,1,Q,H): j
    ii = torch.arange(q, device=xs.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # masked BEFORE the exp: above the diagonal li − lj >= 0 grows with
    # the chunk's summed decay, and once exp overflows, the gradient of a
    # where() taken after it is 0 · inf = NaN (the reference's is, past a
    # summed decay of ~88); exp(−inf) is the same 0 with a zero gradient
    L = torch.exp(torch.where(causal, li - lj,
                              torch.full((), float("-inf"), device=xs.device)))
    CB = torch.einsum("bcin,bcjn->bcij", _in(C_c, cd), _in(B_c, cd))
    M = (CB[..., None] * L * dt_c[:, :, None, :, :]).to(cd)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", M.to(torch.float32),
                          _in(xs_c, cd))

    # chunk states
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)     # (B,c,Q,H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", _in(B_c, cd),
                          _in(decay_end * dt_c, cd), _in(xs_c, cd))

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])          # (B,c,H)
    hcur = (torch.zeros((b, h, n, p), dtype=torch.float32, device=xs.device)
            if h_init is None else h_init.to(torch.float32))
    prevs = []
    for c in range(nc):
        prevs.append(hcur)
        hcur = chunk_decay[:, c, :, None, None] * hcur + states[:, c]
    h_prevs = torch.stack(prevs, dim=1)                # (B,c,H,N,P)

    y_off = torch.einsum("bcin,bchnp,bcih->bcihp", _in(C_c, cd),
                         _in(h_prevs, cd), _in(torch.exp(cum), cd))
    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :s]
    return y.to(xs.dtype), hcur


def mamba2_apply(x: torch.Tensor, prm: Dict, cfg: ModelConfig, ctx) -> torch.Tensor:
    """Full-sequence Mamba2 mixer. x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    di, h, p = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim

    z, xs, Bm, Cm, dt = _project_in(x, prm, ctx)
    # the depthwise conv one segment at a time: the fused conv's math,
    # with each segment keeping its own tensor-parallel layout
    (x0, x1), (b0, b1), (c0, c1) = _conv_slices(cfg)
    cw, cb = prm["conv_w"], prm["conv_b"]
    xs = F.silu(_causal_conv(xs, cw[:, x0:x1], cb[x0:x1]))
    Bm = F.silu(_causal_conv(Bm, cw[:, b0:b1], cb[b0:b1]))
    Cm = F.silu(_causal_conv(Cm, cw[:, c0:c1], cb[c0:c1]))
    xs = ctx.tap("conv_out", xs)
    xs = xs.reshape(b, s, h, p)

    dtp = F.softplus(dt.to(torch.float32) + prm["dt_bias"])
    A = -torch.exp(prm["A_log"])
    cd = torch.bfloat16 if cfg.ssm_compute_dtype == "bfloat16" else torch.float32
    y, _ = ssd_chunked(xs, dtp, A, Bm, Cm, cfg.ssm_chunk, compute_dtype=cd)
    y = y + prm["D"][None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(b, s, di).to(x.dtype)
    y = ctx.tap("ssd_out", y)
    y = rmsnorm(y * F.silu(z), prm["norm_w"], cfg.norm_eps).to(x.dtype)
    return ctx.matmul("out_proj", y, prm["out_proj"])


class MambaState(NamedTuple):
    h: torch.Tensor           # (..., B, H, N, P) fp32 SSM state
    conv: torch.Tensor        # (..., B, W-1, C) conv tail, the param dtype

    @classmethod
    def zeros(cls, b: int, cfg: ModelConfig, dtype=torch.float32,
              device=None, lead: Tuple[int, ...] = ()) -> "MambaState":
        """Zeroed states with leading dims ``lead`` (layers, or groups and
        their period) before the batch."""
        return cls(
            torch.zeros(lead + (b, cfg.ssm_heads, cfg.ssm_state,
                                cfg.ssm_headdim),
                        dtype=torch.float32, device=device),
            torch.zeros(lead + (b, cfg.conv_width - 1, _conv_channels(cfg)),
                        dtype=dtype, device=device))


def mamba2_decode(x: torch.Tensor, prm: Dict, cfg: ModelConfig, ctx,
                  state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """One-token step. x: (B, 1, D) -> (B, 1, D). Writes the new h and
    conv tail into ``state`` (every row) and returns it."""
    b = x.shape[0]
    di, h, p, n = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state

    z, xs_new, B_new, C_new, dt = _project_in(x[:, 0], prm, ctx)
    xbc_new = torch.cat([xs_new, B_new, C_new], dim=-1)

    window = torch.cat([state.conv, xbc_new[:, None, :].to(state.conv.dtype)],
                       dim=1)                              # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", window.to(torch.float32),
                            prm["conv_w"])
    xbc = F.silu(conv_out + prm["conv_b"]).to(x.dtype)
    state.conv.copy_(window[:, 1:])

    xs = xbc[..., :di].reshape(b, h, p)
    Bm = xbc[..., di:di + n].to(torch.float32)
    Cm = xbc[..., di + n:di + 2 * n].to(torch.float32)
    dtp = F.softplus(dt.to(torch.float32) + prm["dt_bias"])     # (B, H)
    A = -torch.exp(prm["A_log"])
    dA = torch.exp(dtp * A)                                      # (B, H)

    upd = (dtp[:, :, None, None] * Bm[:, None, :, None]
           * xs.to(torch.float32)[:, :, None, :])
    hnew = dA[:, :, None, None] * state.h + upd
    state.h.copy_(hnew)
    y = torch.einsum("bn,bhnp->bhp", Cm, hnew)
    y = y + prm["D"][None, :, None] * xs.to(torch.float32)
    y = y.reshape(b, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), prm["norm_w"], cfg.norm_eps).to(x.dtype)
    out = ctx.matmul("out_proj", y, prm["out_proj"])[:, None, :]
    return out, state
