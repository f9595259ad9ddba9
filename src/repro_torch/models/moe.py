"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k routing,
capacity-bounded scatter dispatch, optional shared experts
(DeepSeek-MoE style).

Tokens are ranked within their expert by a cumsum over the (N·k, E)
assignment matrix, dropped beyond capacity C = int(cf·N·k/E + 0.999),
scattered into an (E, C, D) buffer, run through ``ctx.expert_matmul``
per projection and gathered back weighted by the renormalized gates.
The capacity-sorted (E, C, D) layout plus the per-expert ``counts``
vector is the interface of the grouped ragged kernel: ``Context`` runs
the E FFNs as one einsum, ``DequantContext`` streams the packed expert
stack through ``kernels.grouped_qmm`` in one call. Every op here runs on
the device without a host read, so a decode step keeps no sync.

Capacity couples a token to its batch-mates: which tokens an expert
keeps depends on the total token count of the call and on the rank
order, exactly as in the reference. A request served alone can
therefore differ from the same request served in a batch once an
expert overflows; that is the reference's behaviour, not a fault.

Routers stay fp32 (pinned to >= 8 bits by ``QuantPolicy``, so serving
keeps them fp). Under partition rules with a "model" axis that divides
the experts, ``moe_apply`` runs the expert-parallel ``moe_apply_ep``
(the reference's :71-81).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models.layers import init_dense
from repro_torch.obs import runtime as obs_rt


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def experts_mat(d_in, d_out):
        x = torch.randn((e, d_in, d_out), generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (x * d_in ** -0.5).to(dtype)

    p = {"router": init_dense(gen, d, e, torch.float32),
         "w_up": experts_mat(d, f),
         "w_gate": experts_mat(d, f),
         "w_down": experts_mat(f, d)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {"w_up": init_dense(gen, d, fs, dtype),
                       "w_gate": init_dense(gen, d, fs, dtype),
                       "w_down": init_dense(gen, fs, d, dtype)}
    return p


def _topk_route(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (N, E) -> (gates (N, k) renormalized fp32, idx (N, k)),
    in descending order as ``lax.top_k`` returns them."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp_min(torch.sum(gates, -1, keepdim=True), 1e-9)
    return gates, idx


def moe_apply(x: torch.Tensor, p: Dict, cfg: ModelConfig, ctx
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss). The expert-parallel path when
    partition rules are active with a "model" axis that divides the
    experts, else the single-device path."""
    from repro_torch.models.partition import current_rules
    rules = current_rules()
    if (rules is not None and cfg.num_experts and "model" in rules.mesh.shape
            and cfg.num_experts % rules.mesh.shape["model"] == 0):
        return moe_apply_ep(x, p, cfg, ctx, rules)
    return _moe_apply_auto(x, p, cfg, ctx)


def _moe_apply_auto(x: torch.Tensor, p: Dict, cfg: ModelConfig, ctx
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's single-device path, its dtypes followed step by
    step."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    n = b * s
    xt = x.reshape(n, d)

    logits = xt.to(torch.float32) @ ctx.qw("router", p["router"]).to(torch.float32)
    logits = ctx.tap("router_logits", logits)
    gates, idx = _topk_route(logits, k)                       # (N, k)

    # rank within expert via a cumsum over the (N·k, E) assignments; the
    # one-hot is a comparison (no host read of the indices)
    cap = int(cfg.capacity_factor * n * k / e + 0.999)
    flat_idx = idx.reshape(-1)                                # (N·k,)
    onehot = (flat_idx[:, None] == torch.arange(e, device=x.device)
              ).to(torch.int32)                               # (N·k, E)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=-1)
    keep = pos < cap
    assigned = torch.sum(onehot, dim=0)                       # (E,)
    counts = torch.clamp_max(assigned, cap).to(torch.int32)
    if obs_rt.emitting():
        obs_rt.emit("moe_dropped_tokens", torch.sum(assigned - counts))

    # load-balance aux loss (Switch-style): E * Σ_e f_e · p_e
    me = torch.mean(torch.softmax(logits, -1), dim=0)
    ce = assigned.to(torch.float32) / (n * k)
    aux = e * torch.sum(me * ce)

    # scatter into (E, cap, D): dropped tokens add zeros at (e, cap - 1)
    xk = xt[:, None, :].expand(n, k, d).reshape(n * k, d)     # repeat, k-major
    safe_pos = torch.where(keep, pos, torch.full_like(pos, cap - 1))
    slot = flat_idx * cap + safe_pos                          # (N·k,)
    upd = torch.where(keep[:, None], xk, torch.zeros_like(xk)).to(x.dtype)
    buf = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, slot, upd).reshape(e, cap, d)

    up = ctx.expert_matmul("w_up", buf, p["w_up"], counts)
    gate = F.silu(ctx.expert_matmul("w_gate", buf, p["w_gate"], counts))
    h = ctx.tap("moe_h", up * gate)
    out_buf = ctx.expert_matmul("w_down", h, p["w_down"], counts)

    # gather back, weighted by the gates in the payload dtype; the k slots
    # of a token are contiguous, so the combine is an fp32 sum over k
    pulled = out_buf.reshape(e * cap, d)[slot]                # (N·k, D)
    pulled = torch.where(keep[:, None], pulled, torch.zeros_like(pulled))
    w = gates.reshape(-1)[:, None].to(pulled.dtype)
    y = torch.sum((pulled * w).to(torch.float32).reshape(n, k, d), dim=1)
    y = y.to(x.dtype)

    if cfg.num_shared_experts:
        sp = p["shared"]
        su = ctx.matmul("shared_w_up", xt, sp["w_up"])
        sg = F.silu(ctx.matmul("shared_w_gate", xt, sp["w_gate"]))
        y = y + ctx.matmul("shared_w_down", ctx.tap("shared_h", su * sg),
                           sp["w_down"])
    return y.reshape(b, s, d), aux


# --------------------------------------------------------------------------
# expert parallelism (port of the reference's :161-274)
# --------------------------------------------------------------------------

def _local_expert_ffn(xf: torch.Tensor, w_up, w_gate, w_down,
                      cfg: ModelConfig, ctx, e_loc: int, cap: int,
                      gates: torch.Tensor, idx: torch.Tensor,
                      e_offset: int) -> torch.Tensor:
    """Route xf (N, D, the data row's tokens) through one model shard's
    ``e_loc`` experts (slabs (e_loc, D, F) / (e_loc, F, D), already
    through ``ctx.qw``). Returns the shard's PARTIAL combine (N, D) fp32:
    only its experts' contributions; the caller sums over "model"."""
    n, d = xf.shape
    k = cfg.top_k
    flat_idx = idx.reshape(-1)                            # (N·k,) global ids
    local = flat_idx - e_offset                           # id within the slab
    mine = (local >= 0) & (local < e_loc)
    local_c = torch.clamp(local, 0, e_loc - 1)

    onehot = ((local_c[:, None] == torch.arange(e_loc, device=xf.device))
              & mine[:, None]).to(torch.int32)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=-1)
    keep = mine & (pos < cap)
    safe_pos = torch.where(keep, pos, torch.full_like(pos, cap - 1))
    slot = local_c * cap + safe_pos

    xk = xf[:, None, :].expand(n, k, d).reshape(n * k, d)
    upd = torch.where(keep[:, None], xk, torch.zeros_like(xk)).to(xf.dtype)
    buf = torch.zeros((e_loc * cap, d), dtype=xf.dtype, device=xf.device)
    buf = buf.index_add(0, slot, upd).reshape(e_loc, cap, d)

    up = torch.einsum("ecd,edf->ecf", buf, w_up)
    gate = F.silu(torch.einsum("ecd,edf->ecf", buf, w_gate))
    h = ctx.tap("moe_h", up * gate)
    out_buf = torch.einsum("ecf,efd->ecd", h, w_down)

    pulled = out_buf.reshape(e_loc * cap, d)[slot]
    pulled = torch.where(keep[:, None], pulled, torch.zeros_like(pulled))
    w = gates.reshape(-1)[:, None].to(pulled.dtype)
    return torch.sum((pulled * w).to(torch.float32).reshape(n, k, d), dim=1)


def moe_apply_ep(x: torch.Tensor, p: Dict, cfg: ModelConfig, ctx, rules
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over the "model" axis, for one data row.

    ``ctx`` is the row's ``models.context.MeshContext``. The row's tokens
    are replicated on its model shards (the port keeps activations
    replicated within a row, so the reference's all-gather of
    sequence-parallel tokens is not needed). The router runs once on the
    row's lead shard; each model shard routes the row's tokens through
    its E/mp experts with shard-local scatters, at the reference's
    capacity ``cap = ceil(cf · n_row · k / E)`` a data row; the fp32
    partials are ``psum``'d over "model" in shard order. Shared experts
    ride the same sum as column-parallel FFNs: each shard adds its
    columns' contribution. The ``moe_h`` / ``shared_h`` taps see a
    shard's slab, as the reference's per-shard body does. The aux loss
    is the row's: the step averages
    the rows' losses (a ``pmean`` over the data axes), which is the
    reference's in-body ``pmean`` of the aux term."""
    mesh = rules.mesh
    mp = mesh.shape["model"]
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    e_loc = e // mp
    if getattr(ctx, "row", None) is None or len(ctx.row) != mp:
        raise ValueError("moe_apply_ep needs the data row's MeshContext")
    n_row = b * s
    cap = int(cfg.capacity_factor * n_row * k / e + 0.999)
    xf = x.reshape(n_row, d)

    logits = xf.to(torch.float32) @ ctx.qw("router", p["router"]).to(torch.float32)
    logits = ctx.tap("router_logits", logits)
    gates, idx = _topk_route(logits, k)

    me = torch.mean(torch.softmax(logits, -1), dim=0)
    onehot = (idx.reshape(-1)[:, None] == torch.arange(e, device=x.device))
    ce = torch.sum(onehot.to(torch.float32), dim=0) / (n_row * k)
    aux = e * torch.sum(me * ce)

    ys = {}
    for i, c in enumerate(ctx.row):
        dev = mesh.device(c)
        xl = xf.to(dev)
        y = _local_expert_ffn(
            xl, ctx.expert_slab("w_up", c), ctx.expert_slab("w_gate", c),
            ctx.expert_slab("w_down", c), cfg, ctx, e_loc, cap,
            gates.to(dev), idx.to(dev), i * e_loc)
        if cfg.num_shared_experts:
            su = xl @ ctx.shard_weight("shared_w_up", c, 1)
            sg = F.silu(xl @ ctx.shard_weight("shared_w_gate", c, 1))
            y = y + (ctx.tap("shared_h", su * sg)
                     @ ctx.shard_weight("shared_w_down", c, 0)).to(torch.float32)
        ys[c] = y
    # rpr-ok: RPR002 training-path fp32 expert combine, folded in shard order (serving MoE dispatch never psums)
    y = mesh.psum(ys, "model")[ctx.lead]
    return y.to(x.dtype).reshape(b, s, d), aux
