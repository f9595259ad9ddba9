"""Load generation: Poisson / trace-driven request streams with synthetic
prompts (copy of ``repro.serve.loadgen``).

Two shapes of load:

  * ``poisson_requests`` — open-loop arrivals with exponential
    inter-arrival gaps at a target rate (requests per clock unit), the
    standard serving-benchmark model. Prompt and generation lengths draw
    uniformly from ranges, so slots free up at different times and the
    engine's eviction/backfill path is continuously exercised.
  * ``trace_requests`` — explicit (arrival, prompt_len, gen_len) tuples,
    for deterministic tests and replaying recorded traffic.

All randomness is seeded; the same seed reproduces the same trace.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple, Union

import numpy as np

from repro_torch.configs import ModelConfig
from repro_torch.serve.request import Request
from repro_torch.serve.sampling import SamplingParams

LenRange = Union[int, Tuple[int, int]]


def _draw(rng: np.random.Generator, r: LenRange) -> int:
    if isinstance(r, int):
        return r
    lo, hi = r
    return int(rng.integers(lo, hi + 1))


def synth_prompt(rng: np.random.Generator, length: int, cfg: ModelConfig,
                 prefix: Optional[np.ndarray] = None) -> np.ndarray:
    """Random token prompt with the family's shape ((P,) or (P, CB)).

    ``prefix`` makes the first ``min(len(prefix), length - 1)`` tokens a
    SHARED prefix (identical across requests built with the same prefix
    array) — the workload shape that exercises the paged KV cache's
    hash-based prefix sharing. At least one token stays unique-random so
    every request still prefills something; a prompt too short to hold
    any shared token (``length <= 1``) is rejected rather than silently
    dropping the sharing the caller asked for.
    """
    shape = (length, cfg.num_codebooks) if cfg.family == "audio" else (length,)
    prompt = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    if prefix is not None:
        if length <= 1:
            raise ValueError(
                f"prompt length {length} cannot carry a shared prefix: "
                "at least one token must stay unique, so prefixed "
                "prompts need length >= 2")
        prefix = np.asarray(prefix)
        if cfg.family == "audio":
            if prefix.ndim != 2 or prefix.shape[1] != cfg.num_codebooks:
                raise ValueError(
                    f"audio prefix must be (P, {cfg.num_codebooks}) to "
                    f"match the prompt's codebooks, got {prefix.shape}")
        elif prefix.ndim != 1:
            raise ValueError(
                f"prefix must be a 1-d token array, got shape {prefix.shape}")
        n = min(prefix.shape[0], length - 1)
        if n > 0:
            prompt[:n] = prefix[:n]
    return prompt


def _shared_prefix(rng: np.random.Generator, prefix_len: int,
                   cfg: ModelConfig) -> Optional[np.ndarray]:
    if prefix_len <= 0:
        return None
    return synth_prompt(rng, prefix_len, cfg)


def poisson_requests(cfg: ModelConfig, n: int, rate: float,
                     prompt_len: LenRange = (16, 64),
                     gen_len: LenRange = (8, 32),
                     sampling: Optional[SamplingParams] = None,
                     eos_id: Optional[int] = None,
                     prefix_len: int = 0,
                     seed: int = 0) -> list:
    """``n`` requests with Poisson arrivals at ``rate`` per clock unit.
    ``prefix_len`` > 0 gives every prompt a common leading token span
    (system-prompt-style traffic; see ``synth_prompt``)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), n)
    arrivals = np.cumsum(gaps)
    base = sampling or SamplingParams()
    prefix = _shared_prefix(rng, prefix_len, cfg)
    out = []
    for i in range(n):
        out.append(Request(
            id=i,
            prompt=synth_prompt(rng, _draw(rng, prompt_len), cfg, prefix),
            max_new_tokens=_draw(rng, gen_len),
            arrival_time=float(arrivals[i]),
            sampling=SamplingParams(temperature=base.temperature,
                                    top_k=base.top_k, top_p=base.top_p,
                                    seed=base.seed + i),
            eos_id=eos_id,
        ))
    return out


def trace_requests(cfg: ModelConfig,
                   trace: Iterable[Tuple[float, int, int]],
                   sampling: Optional[SamplingParams] = None,
                   eos_id: Optional[int] = None,
                   prefix_len: int = 0,
                   seed: int = 0) -> list:
    """Requests from explicit (arrival_time, prompt_len, gen_len) rows."""
    rng = np.random.default_rng(seed)
    base = sampling or SamplingParams()
    prefix = _shared_prefix(rng, prefix_len, cfg)
    out = []
    for i, (at, plen, glen) in enumerate(trace):
        out.append(Request(
            id=i,
            prompt=synth_prompt(rng, int(plen), cfg, prefix),
            max_new_tokens=int(glen),
            arrival_time=float(at),
            sampling=SamplingParams(temperature=base.temperature,
                                    top_k=base.top_k, top_p=base.top_p,
                                    seed=base.seed + i),
            eos_id=eos_id,
        ))
    return out
