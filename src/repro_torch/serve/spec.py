"""Self-speculative decoding: FIT-allocated low-bit draft, exact verify
(port of ``repro.serve.spec``).

A draft pass decodes ``k`` tokens per dispatch through a second context
over the SAME parameter tree — optionally narrowed to FIT-chosen widths
(``derive_draft_params``) — with its own low-bit KV lane; a verify pass
then runs ONE multi-token forward of the serving config over (last
token + k drafts) and re-samples every position with the engine's
per-request keys.

Acceptance is coupled (common-random-number) rejection sampling: the
verify pass recomputes what the non-speculative engine would have
sampled at token index ``nwritten + i`` — the same logits (a T-token
``decode_step`` is bitwise T one-token steps, see
``models.decode.decode_step``), the same ``fold_in(seed, t)`` key, the
same sampler — and accepts the longest draft prefix that matches.
Emitted tokens are therefore bit-identical to non-speculative serving in
every mode, greedy and sampled: the draft lane changes how many tokens a
dispatch yields, never which tokens.

Per dispatch the engine emits ``a + 1`` tokens (``a`` = matched prefix
length, plus the correction-or-bonus token), so progress is guaranteed
even at accept rate zero. Rollback is positional: rejected KV writes
stay in the cache past the rolled-back position, masked by the per-row
causal mask and overwritten as the stream advances.

MoE caveat (the reference's own engine behaviour): capacity couples a
token to its batch-mates, and variable per-slot acceptance shifts how
requests pair up across dispatches, so spec == plain for MoE holds with
capacity non-binding (a high ``capacity_factor``); dense and paged
parity is unconditional.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Mapping, Optional, Union

import torch

from repro_torch.models.attention import (  # noqa: F401  (KV_SCALE re-exported)
    KV_SCALE, quantize_dense_kv_values)
from repro_torch.quant.policy import BitConfig

log = logging.getLogger("repro_torch.serve.spec")

# the dense draft lane reuses attention_decode's static int8 KV path
# (its grid: ``KV_SCALE``)
DENSE_DRAFT_KV_BITS = (8, 16)


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding shape for ``EngineConfig(spec=...)``.

    ``k`` — draft tokens proposed per dispatch; ``k <= 1`` degenerates
    to the plain burst scheduler.

    ``draft_bits`` — None serves the draft from the serving tree itself
    (the pure low-bit-KV draft); an int or a {block path -> bits}
    mapping (or a ``BitConfig``) narrows the QTensor tree to those
    widths for the draft pass only (``derive_draft_params``). Use
    ``repro_torch.core.fit.allocate_draft_bits`` to pick it from a
    sensitivity report.

    ``draft_kv_bits`` — the draft lane's KV storage width: 8 or 16 for
    dense serving (the static-scale int8 cache), any paged width
    (16/8/6/4/3) when the engine serves paged.

    ``int8_compute`` — run the draft's quantized blocks through the
    integer kernels; default False = fp-dequant matmuls.

    ``materialize_draft`` — dequantize the draft's QTensor tree once at
    engine init into plain fp weights (default True): the draft then
    pays the fp matmul per step instead of re-dequantizing every weight
    each of the k draft steps; the draft's values (and the FIT accept
    trade) are unchanged.
    """

    k: int = 4
    draft_bits: Optional[Union[int, Mapping[str, int], BitConfig]] = None
    draft_kv_bits: int = 8
    int8_compute: bool = False
    materialize_draft: bool = True

    @property
    def enabled(self) -> bool:
        return self.k > 1


def derive_draft_params(params, draft_bits, group_size: Optional[int] = None):
    """Narrow a packed QTensor tree to the draft widths.

    Each matmul block whose draft width is below its stored width is
    dequantized and re-packed at the draft width (per-output-channel /
    per-expert scales recomputed); blocks at or above their stored width
    are shared by reference — zero extra bytes. Non-QTensor leaves pass
    through untouched."""
    from repro_torch.qtensor import QTensor, quantize, quantize_experts
    from repro_torch.quant.policy import QuantPolicy
    from repro_torch.serve.quantized import _block_bits, _require_unrolled
    from repro_torch.utils.pytree import map_with_names

    _require_unrolled(params)
    if isinstance(draft_bits, BitConfig):
        bit_cfg = draft_bits
    elif isinstance(draft_bits, int):
        bit_cfg = None
    else:
        bit_cfg = BitConfig(dict(draft_bits), {})
    policy = QuantPolicy()
    n_narrowed = 0

    def one(name, leaf):
        nonlocal n_narrowed
        if not isinstance(leaf, QTensor):
            return leaf
        if bit_cfg is None:
            b = int(draft_bits)
        else:
            b = _block_bits(bit_cfg, name, leaf, policy)
            if b is None:
                return leaf
        if b >= leaf.bits:
            return leaf                      # cannot add information back
        gs = group_size if group_size is not None else (
            leaf.group_size if leaf.group_size < leaf.shape[-2] else None)
        w = leaf.dequantize(torch.float32)
        n_narrowed += 1
        return (quantize_experts(w, b, group_size=gs) if leaf.ndim == 3
                else quantize(w, b, group_size=gs))

    out = map_with_names(one, params)
    log.info("draft tree: %d blocks narrowed for the draft pass", n_narrowed)
    return out


def quantize_dense_kv(kv: torch.Tensor, draft_kv_bits: int) -> torch.Tensor:
    """Prefilled fp KV -> the dense draft lane's storage, on exactly the
    grid ``attention_decode`` writes an int8 cache with (static
    symmetric scale), so admission-seeded prefix KV and decode-written
    KV live on one grid."""
    if draft_kv_bits == 16:
        return kv
    if draft_kv_bits != 8:
        raise ValueError(
            f"dense draft KV lane supports bits in {DENSE_DRAFT_KV_BITS}, "
            f"got {draft_kv_bits}")
    return quantize_dense_kv_values(kv)


def accept_drafts(drafts: torch.Tensor, targets: torch.Tensor,
                  active: torch.Tensor, nwritten: torch.Tensor,
                  budget: torch.Tensor):
    """Vectorized coupled-rejection accept.

    drafts: (S, k) draft tokens d_1..d_k; targets: (S, k+1) the verify
    pass's re-sampled tokens t_0..t_k (t_i is what the non-speculative
    engine samples at index nwritten+i); active (S,) bool;
    nwritten/budget (S,) integers.

    Returns ``(n_emit, n_match)``: ``n_match`` is the matched prefix
    length a (0..k); ``n_emit = min(a + 1, budget - nwritten)`` tokens —
    the matched prefix plus the correction-or-bonus token, clamped to
    the slot's remaining output budget — and 0 for inactive slots.
    """
    k = drafts.shape[1]
    match = drafts == targets[:, :k]
    run = torch.cumprod(match.to(torch.int64), dim=1)
    n_match = torch.sum(run, dim=1)                         # (S,) 0..k
    room = torch.clamp_min(budget - nwritten, 0)
    n_emit = torch.minimum(n_match + 1, room)
    n_emit = torch.where(active, n_emit, torch.zeros_like(n_emit))
    return n_emit, n_match
