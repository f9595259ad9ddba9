"""Token sampling for the serving engine (port of ``repro.serve.sampling``).

Only greedy decoding is ported: sampled decoding (temperature > 0) needs
its own per-request generator contract and waits for a later slice.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration; temperature <= 0 is greedy."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis in fp32 (first maximum on ties)."""
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)
