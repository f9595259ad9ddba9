"""Deterministic synthetic LM stream (copy of ``repro.data.synthetic``).

A first-order Markov chain over the vocab (permutation structure +
noise), seeded and host-shardable: worker ``i`` of ``n`` draws disjoint,
reproducible slices. Batches are numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class LMStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    noise: float = 0.1
    num_codebooks: int = 0          # >0: audio-style (B, S, CB) grids
    img_tokens: int = 0             # >0: vlm-style image_embed prefix
    d_model: int = 0                # for image_embed width
    seed: int = 0


def lm_batches(cfg: LMStreamConfig, shard_index: int = 0, num_shards: int = 1
               ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {"tokens", "labels"[, "image_embed"]} with local batch dim."""
    assert cfg.global_batch % num_shards == 0
    local = cfg.global_batch // num_shards
    rng = np.random.default_rng(cfg.seed * 100003 + shard_index)
    perm = np.random.default_rng(cfg.seed).permutation(cfg.vocab_size)

    def chain(shape) -> np.ndarray:
        steps = shape[-1]
        out = np.empty(shape, np.int64)
        cur = rng.integers(0, cfg.vocab_size, shape[:-1])
        for t in range(steps):
            out[..., t] = cur
            nxt = perm[cur]
            flip = rng.random(cur.shape) < cfg.noise
            rand = rng.integers(0, cfg.vocab_size, cur.shape)
            cur = np.where(flip, rand, nxt)
        return out

    while True:
        if cfg.num_codebooks:
            toks = chain((local, cfg.num_codebooks, cfg.seq_len + 1)).transpose(0, 2, 1)
            batch = {"tokens": toks[:, :-1].astype(np.int32),
                     "labels": toks[:, 1:].astype(np.int32)}
        else:
            toks = chain((local, cfg.seq_len + 1))
            batch = {"tokens": toks[:, :-1].astype(np.int32),
                     "labels": toks[:, 1:].astype(np.int32)}
        if cfg.img_tokens:
            batch["image_embed"] = rng.normal(
                0, 1, (local, cfg.img_tokens, cfg.d_model)).astype(np.float32)
            batch["tokens"] = batch["tokens"][:, :cfg.seq_len - cfg.img_tokens]
        yield batch
