"""Request lifecycle for the continuous-batching engine
(copy of ``repro.serve.request``).

A ``Request`` is one user generation: a prompt, a token budget, sampling
parameters, and an arrival time (from the load generator). The engine
moves it through

    QUEUED -> PREFILLING -> RUNNING -> FINISHED

recording the timestamps the metrics module needs (admission delay, TTFT,
end-to-end latency). See ``repro.serve.engine`` and ROADMAP.md (serving
north star).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from repro_torch.serve.sampling import SamplingParams


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One generation request.

    ``prompt`` is an int32 token array of shape (P,) — or (P, CB) for the
    multi-codebook audio family. ``arrival_time`` is in the engine's clock
    units (seconds in wall mode, decode ticks in step mode).
    """

    id: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_time: float = 0.0
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    eos_id: Optional[int] = None

    # ---- engine-owned runtime fields ----
    status: RequestStatus = RequestStatus.QUEUED
    output_tokens: Optional[np.ndarray] = None   # (G,[ CB]) once FINISHED
    slot: Optional[int] = None
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    obs_span: Optional[int] = None       # open tracer span handle (obs)

    def __post_init__(self):
        # fail at construction with a nameable error instead of a shape
        # mismatch (or a silent no-op request) deep inside jitted engine
        # code; keep the converted array so list-built prompts work too
        self.prompt = prompt = np.asarray(self.prompt)
        if prompt.ndim < 1 or prompt.shape[0] < 1:
            raise ValueError(
                f"request {self.id}: prompt must be a non-empty token "
                f"array, got shape {prompt.shape}")
        if self.max_new_tokens <= 0:
            raise ValueError(
                f"request {self.id}: max_new_tokens must be > 0, got "
                f"{self.max_new_tokens}")
        if not 0.0 < self.sampling.top_p <= 1.0:
            raise ValueError(
                f"request {self.id}: top_p must be in (0, 1], got "
                f"{self.sampling.top_p}")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival_time

    @property
    def num_generated(self) -> int:
        return 0 if self.output_tokens is None else int(self.output_tokens.shape[0])
