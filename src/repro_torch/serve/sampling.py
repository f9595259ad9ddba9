"""Token sampling for the serving engine (port of ``repro.serve.sampling``):
greedy / temperature / top-k / top-p, vectorized over request slots
with per-request keys.

Determinism contract: the key for token ``t`` of a request is
``fold_in(fold_in(key(0), seed), t)`` — a function of the request's seed
and the token index only — so a request samples the same tokens alone
or batched, in any slot, after any eviction or backfill. Every op below
works row by row.

The keys and the noise are the reference's own: ``request_keys`` runs
the Threefry-2x32 block cipher of the reference's random-number
generator (key data as int64 tensors holding uint32 values), and the
uniform bits of a categorical draw are Threefry over the counters
0..V-1 of the row's key (``x0 ^ x1``), as the reference's generator
makes them in its partitionable mode. The Gumbel noise
``-log(-log(u))`` then differs from the reference's only by the ulps of
``log``. Plain PyTorch on every device:
the reference's sampler is no Pallas kernel either.

``top_k``/``top_p`` are per-slot values, so the masks are built with a
sort and a threshold, as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

NEG = -1e30
_U32 = 0xFFFFFFFF
# Threefry-2x32's rotation schedule and key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    temperature <= 0 selects greedy decoding; ``top_k <= 0`` and
    ``top_p >= 1`` disable their respective filters.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _U32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of counters (x0, x1) under keys (k0, k1):
    int64 tensors holding uint32 values, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def _fold_in(k0: torch.Tensor, k1: torch.Tensor, data: torch.Tensor):
    # fold_in(key, d) = threefry(key, (0, uint32(d)))
    return threefry2x32(k0, k1, torch.zeros_like(data), data & _U32)


def request_keys(seeds: torch.Tensor, token_idx: torch.Tensor) -> torch.Tensor:
    """(B,) integer seeds + (B,) token indices -> (B, 2) int64 tensor of
    uint32 key data: ``fold_in(fold_in(key(0), seed), t)``, the
    reference's key data. A negative int32 seed wraps to uint32 as the
    reference's ``fold_in`` wraps it."""
    s = seeds.to(torch.int64)
    t = token_idx.to(torch.int64)
    zero = torch.zeros_like(s)
    k0, k1 = _fold_in(zero, zero, s)
    k0, k1 = _fold_in(k0, k1, t)
    return torch.stack([k0, k1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, 2) key data -> (B, n) int64 holding the uint32 bits the
    reference's ``bits(key, (n,))`` gives each row: Threefry over the
    counters (0, i) for i < n, the two output words xor-ed."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) fp32 uniforms in [tiny, 1) from each row's key, as the
    reference's ``uniform(key, (n,), minval=tiny)``: the 23 high bits as
    a mantissa of [1, 2), minus 1, then ``* (1 - tiny) + tiny`` and
    ``max(tiny, ·)``."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    one = torch.ones((), dtype=torch.float32, device=keys.device)
    f = f * (one - _TINY) + _TINY
    return torch.clamp_min(f, _TINY)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) fp32 standard Gumbel noise ``-log(-log(u))``."""
    return -torch.log(-torch.log(uniform(keys, n)))


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor, skip_filters: bool = False
                  ) -> torch.Tensor:
    """Sample one token per slot.

    logits: (B, V) — or (B, CB, V) for the audio family, whose codebooks
    sample independently under one key (the row's noise is Threefry over
    the counters 0..CB·V-1, as the reference draws a (CB, V) categorical);
    keys: (B, 2) from ``request_keys``; temperature/top_k/top_p: (B,).
    Returns int32 (B,) (or (B, CB)).

    ``skip_filters=True`` elides the sort-based top-k/top-p masks; a row
    with ``top_k <= 0, top_p >= 1`` samples the same either way, so a
    filterless request batched with filtered ones keeps its tokens.
    """
    v = logits.shape[-1]
    # per-slot values broadcast against (B[, CB], V) and (B[, CB])
    shape1 = (logits.shape[0],) + (1,) * (logits.ndim - 1)
    lg32 = logits.to(torch.float32)
    greedy = (temperature <= 0.0).reshape(shape1[:-1])
    t = torch.clamp_min(temperature.to(torch.float32), 1e-6).reshape(shape1)
    lg = lg32 / t

    if not skip_filters:
        # top-k: keep entries >= the k-th largest value of the row
        desc = torch.sort(lg, dim=-1, descending=True).values
        k_idx = torch.clamp(top_k.to(torch.int64) - 1, 0, v - 1).reshape(shape1)
        kth = torch.gather(desc, -1, k_idx.expand(desc.shape[:-1] + (1,)))
        k_on = (top_k > 0).reshape(shape1)
        lg = torch.where(k_on & (lg < kth), torch.full_like(lg, NEG), lg)

        # top-p: the smallest prefix of the descending distribution whose
        # mass reaches top_p; top_p is clamped to 1e-9 so top_p <= 0
        # keeps exactly the argmax; ties at the threshold are all kept
        probs = torch.softmax(lg, dim=-1)
        p_desc = torch.sort(probs, dim=-1, descending=True).values
        csum = torch.cumsum(p_desc, dim=-1)
        p_eff = torch.clamp_min(top_p.to(torch.float32), 1e-9).reshape(shape1)
        keep_sorted = (csum - p_desc) < p_eff
        thresh = torch.amin(torch.where(keep_sorted, p_desc,
                                        torch.full_like(p_desc, float("inf"))),
                            dim=-1, keepdim=True)
        lg = torch.where(probs < thresh, torch.full_like(lg, NEG), lg)

    noise = gumbel(keys, lg[0].numel()).reshape(lg.shape)
    sampled = torch.argmax(lg + noise, dim=-1)
    return torch.where(greedy, torch.argmax(lg32, dim=-1),
                       sampled).to(torch.int32)


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis in fp32 (first maximum on ties): the
    tokens ``sample_tokens`` gives at temperature <= 0, without the
    noise and the sorts."""
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)
