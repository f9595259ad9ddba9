"""Deterministic synthetic datasets (copy of ``repro.data.synthetic``;
numpy only, so the arrays equal the reference's bit for bit).

Every generator is seeded and host-shardable: worker ``i`` of ``n`` draws
disjoint, reproducible slices. Batches are numpy arrays.

  * LM stream: first-order Markov chain over the vocab (permutation
    structure + noise), with the audio family's (B, S, CB) grids and the
    vlm family's ``image_embed`` prefix.
  * Classification: K gaussian clusters (the paper's Table-2 CNN
    testbed's stand-in data).
  * Segmentation: images of random rectangles/disks/stripes with
    per-pixel class labels (the paper's U-Net study's stand-in data).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

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


@dataclasses.dataclass
class ClassifyConfig:
    num_classes: int = 10
    input_hw: int = 16
    channels: int = 3
    teacher_hidden: int = 64
    label_noise: float = 0.02
    seed: int = 0


def classify_dataset(cfg: ClassifyConfig, n: int, split_seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x (n, H, W, C), y (n,)): gaussian clusters, cluster-id
    labels with a small flip rate. Learnable to ~(1−noise) by the small
    CNN, leaving measurable headroom for quantization degradation."""
    rng = np.random.default_rng(cfg.seed * 7919 + split_seed)
    d = cfg.input_hw * cfg.input_hw * cfg.channels
    trng = np.random.default_rng(cfg.seed)
    centers = trng.normal(0, 1.0, (cfg.num_classes, d))

    cls = rng.integers(0, cfg.num_classes, n)
    x = centers[cls] * 0.8 + rng.normal(0, 1.0, (n, d))
    flip = rng.random(n) < cfg.label_noise
    y = np.where(flip, rng.integers(0, cfg.num_classes, n), cls)
    return (x.reshape(n, cfg.input_hw, cfg.input_hw, cfg.channels)
            .astype(np.float32), y.astype(np.int32))


@dataclasses.dataclass
class SegmentConfig:
    input_hw: int = 32
    channels: int = 3
    num_classes: int = 4            # bg, rect, disk, stripe
    max_shapes: int = 3
    seed: int = 0


def segment_dataset(cfg: SegmentConfig, n: int, split_seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x (n,H,W,C), y (n,H,W) int labels)."""
    rng = np.random.default_rng(cfg.seed * 104729 + split_seed)
    hw = cfg.input_hw
    xs = rng.normal(0, 0.3, (n, hw, hw, cfg.channels)).astype(np.float32)
    ys = np.zeros((n, hw, hw), np.int32)
    yy, xx = np.mgrid[0:hw, 0:hw]
    for i in range(n):
        for _ in range(rng.integers(1, cfg.max_shapes + 1)):
            kind = rng.integers(1, cfg.num_classes)
            cx, cy = rng.integers(4, hw - 4, 2)
            r = rng.integers(3, hw // 4)
            if kind == 1:
                mask = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < r)
            elif kind == 2:
                mask = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
            else:
                mask = np.abs((xx - cx) + (yy - cy)) < max(r // 2, 2)
            ys[i][mask] = kind
            xs[i][mask] += rng.normal(0.5 + 0.5 * kind, 0.1)
    return xs, ys


def batched(x: np.ndarray, y: np.ndarray, batch: int, seed: int = 0,
            epochs: Optional[int] = None) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    n = len(x)
    ep = 0
    while epochs is None or ep < epochs:
        order = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            sel = order[i:i + batch]
            yield x[sel], y[sel]
        ep += 1
