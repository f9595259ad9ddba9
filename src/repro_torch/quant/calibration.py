"""Calibration observers for activation quantization ranges (port of
``repro.quant.calibration``).

Weights use direct min–max (they are static at a given step). Activations
are calibrated over batches: ``MinMaxObserver`` tracks the running
min/max, ``EmaObserver`` an exponential moving average (the QAT scheme
of the paper's Appendix A). Observers are functional: ``update`` returns
a new state and leaves the old one as it was. The state stays on the
device of the activations, so calibrating never syncs with the host.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device


class RangeState(NamedTuple):
    lo: torch.Tensor
    hi: torch.Tensor
    initialized: torch.Tensor  # bool scalar


def init_range_state(device: DeviceLike = None) -> RangeState:
    """An empty range on ``device`` (default: the GPU)."""
    dev = resolve_device(device)
    z = torch.zeros((), dtype=torch.float32, device=dev)
    return RangeState(z, z.clone(), torch.zeros((), dtype=torch.bool, device=dev))


def _batch_range(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    lo = torch.clamp_max(torch.amin(x).to(torch.float32), 0.0)
    hi = torch.clamp_min(torch.amax(x).to(torch.float32), 0.0)
    return lo, hi


@dataclasses.dataclass(frozen=True)
class MinMaxObserver:
    def update(self, state: RangeState, x: torch.Tensor) -> RangeState:
        lo, hi = _batch_range(x)
        new_lo = torch.where(state.initialized, torch.minimum(state.lo, lo), lo)
        new_hi = torch.where(state.initialized, torch.maximum(state.hi, hi), hi)
        return RangeState(new_lo, new_hi, torch.ones_like(state.initialized))


@dataclasses.dataclass(frozen=True)
class EmaObserver:
    decay: float = 0.99

    def update(self, state: RangeState, x: torch.Tensor) -> RangeState:
        lo, hi = _batch_range(x)
        new_lo = torch.where(state.initialized,
                             self.decay * state.lo + (1 - self.decay) * lo, lo)
        new_hi = torch.where(state.initialized,
                             self.decay * state.hi + (1 - self.decay) * hi, hi)
        return RangeState(new_lo, new_hi, torch.ones_like(state.initialized))
