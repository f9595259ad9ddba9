"""Serving metrics: TTFT, per-token decode latency, throughput, occupancy
(copy of ``repro.serve.metrics``).

The engine reports events (prefill chunks, decode bursts, request
completions); ``summary()`` reduces them to the numbers a serving
dashboard wants — p50/p95/p99 TTFT and token latency, decode tokens/s,
mean slot occupancy (the continuous-batching figure of merit: a static
batch drains to one straggler, continuous batching keeps slots full),
and — when the paged KV cache is active — page-pool peaks, per-request
KV HBM bytes, and prefix-sharing savings.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


def _pct(xs: List[float], q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(xs), q)) if xs else None


@dataclasses.dataclass
class EngineMetrics:
    max_slots: int = 1

    # raw event streams
    ttfts: List[float] = dataclasses.field(default_factory=list)
    e2e_latencies: List[float] = dataclasses.field(default_factory=list)
    token_lat_s: List[float] = dataclasses.field(default_factory=list)
    prefill_s: float = 0.0
    prefill_tokens: int = 0
    decode_s: float = 0.0
    decode_tokens: int = 0
    decode_steps: int = 0
    occupied_slot_steps: int = 0
    runnable_slot_steps: int = 0      # slots that HAD work, per step
    n_finished: int = 0
    prefill_dispatches: int = 0
    admission_deferrals: int = 0      # admissions bounced on a full pool
    # paged KV cache (zeroed / None for the dense cache)
    kv_total_pages: int = 0
    kv_page_bytes: float = 0.0        # HBM bytes per page, all layers
    kv_peak_pages: int = 0
    kv_req_bytes: List[float] = dataclasses.field(default_factory=list)
    kv_shared_tokens: int = 0         # prefill tokens skipped via sharing
    kv_cow_copies: int = 0

    def record_prefill(self, wall_dt: float, n_tokens: int) -> None:
        self.prefill_s += wall_dt
        self.prefill_tokens += n_tokens
        self.prefill_dispatches += 1

    def record_burst(self, wall_dt: float, steps: int, n_active: int,
                     n_tokens: Optional[int] = None,
                     n_runnable: Optional[int] = None,
                     per_slot_tokens: Optional[List[int]] = None) -> None:
        """``n_tokens`` is the USEFUL token count (bursts may overshoot a
        nearly-finished slot; those writes are dropped). ``n_runnable``
        is how many slots COULD have held work during this burst (active
        + arrived-but-waiting, capped at max_slots); it defaults to
        max_slots, which keeps the legacy all-slots denominator.

        ``per_slot_tokens`` lists each active slot's USEFUL token count
        for this burst. A slot's request waits the full burst wall time
        for whatever tokens it got, so its per-token latency is
        ``wall_dt / tokens`` — which equals the legacy ``wall_dt /
        steps`` when the slot filled the burst, but stays honest when a
        nearly-finished slot's overshoot writes were dropped, and for
        speculative bursts where one dispatch yields a variable number
        of accepted tokens per slot. Without it, ``wall_dt / steps`` was
        attributed per useful token, understating overshoot latency
        while occupancy already used the useful count."""
        if per_slot_tokens is not None:
            per_slot_tokens = [int(e) for e in per_slot_tokens if e > 0]
            if n_tokens is None:
                n_tokens = sum(per_slot_tokens)
        if n_tokens is None:
            n_tokens = steps * n_active
        if n_runnable is None:
            n_runnable = self.max_slots
        self.decode_s += wall_dt
        self.decode_tokens += n_tokens
        self.decode_steps += steps
        self.occupied_slot_steps += n_tokens
        self.runnable_slot_steps += steps * min(n_runnable, self.max_slots)
        if per_slot_tokens:
            for e in per_slot_tokens:
                self.token_lat_s.extend([wall_dt / e] * e)
        elif n_tokens and steps:
            # legacy attribution (no per-slot breakdown available):
            # evenly across the burst's steps
            self.token_lat_s.extend([wall_dt / steps] * n_tokens)

    def record_deferral(self) -> None:
        """An arrived request could not be admitted (KV pool full)."""
        self.admission_deferrals += 1

    def record_request(self, req) -> None:
        self.n_finished += 1
        if req.ttft is not None:
            self.ttfts.append(float(req.ttft))
        if req.t_finished is not None:
            self.e2e_latencies.append(float(req.t_finished - req.arrival_time))

    def record_kv_usage(self, pages_in_use: int) -> None:
        self.kv_peak_pages = max(self.kv_peak_pages, int(pages_in_use))

    def record_kv_request(self, hbm_bytes: float) -> None:
        """Page footprint (bytes across all layer pools) of one finished
        request — shared pages count toward every sharer."""
        self.kv_req_bytes.append(float(hbm_bytes))

    def summary(self) -> Dict:
        slot_steps = self.decode_steps * self.max_slots
        return {
            "n_finished": self.n_finished,
            "ttft_p50": _pct(self.ttfts, 50),
            "ttft_p95": _pct(self.ttfts, 95),
            "ttft_p99": _pct(self.ttfts, 99),
            "e2e_p50": _pct(self.e2e_latencies, 50),
            "e2e_p95": _pct(self.e2e_latencies, 95),
            "e2e_p99": _pct(self.e2e_latencies, 99),
            "token_latency_p50_ms": (None if not self.token_lat_s else
                                     1e3 * _pct(self.token_lat_s, 50)),
            "token_latency_p95_ms": (None if not self.token_lat_s else
                                     1e3 * _pct(self.token_lat_s, 95)),
            "token_latency_p99_ms": (None if not self.token_lat_s else
                                     1e3 * _pct(self.token_lat_s, 99)),
            "decode_tokens": self.decode_tokens,
            "decode_tokens_per_s": (self.decode_tokens / self.decode_s
                                    if self.decode_s > 0 else None),
            "prefill_tokens": self.prefill_tokens,
            "prefill_tokens_per_s": (self.prefill_tokens / self.prefill_s
                                     if self.prefill_s > 0 else None),
            "prefill_dispatches": self.prefill_dispatches,
            # occupancy over slots that HAD work (idle tail steps where
            # no request was waiting are not a scheduling failure);
            # slot_occupancy_raw keeps the all-slots denominator
            "slot_occupancy": (
                self.occupied_slot_steps / self.runnable_slot_steps
                if self.runnable_slot_steps else
                (self.occupied_slot_steps / slot_steps
                 if slot_steps else None)),
            "slot_occupancy_raw": (self.occupied_slot_steps / slot_steps
                                   if slot_steps else None),
            "admission_deferrals": self.admission_deferrals,
            # paged KV cache (None when the dense cache is in use)
            "kv_peak_pages": (self.kv_peak_pages
                              if self.kv_total_pages else None),
            "kv_peak_bytes": (self.kv_peak_pages * self.kv_page_bytes
                              if self.kv_total_pages else None),
            "kv_pool_bytes": (self.kv_total_pages * self.kv_page_bytes
                              if self.kv_total_pages else None),
            "kv_peak_occupancy": (self.kv_peak_pages / self.kv_total_pages
                                  if self.kv_total_pages else None),
            "kv_bytes_per_request": (float(np.mean(self.kv_req_bytes))
                                     if self.kv_req_bytes else None),
            "kv_shared_tokens": (self.kv_shared_tokens
                                 if self.kv_total_pages else None),
            "kv_cow_copies": (self.kv_cow_copies
                              if self.kv_total_pages else None),
        }
