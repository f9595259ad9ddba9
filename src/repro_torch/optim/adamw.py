"""AdamW, learning-rate schedules and global-norm clipping (port of
``repro.optim.adamw``).

Parameters and gradients are nested dicts of tensors (the parameter
tree's layout); the moments are fp32 trees of the same structure. The
update follows the reference's "bf16 master-free" recipe: the params
keep their dtype, the update is computed in fp32 and cast back.

Unlike the reference, ``adamw_update`` updates the params and the moments
IN PLACE (and returns them): at full width a second copy of the fp32
moments alone would cost 15 GB for internlm2_1_8b.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.utils.pytree import map_with_names, named_leaves


class AdamState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"          # cosine | linear | constant
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine (or linear) decay to ``min_lr_ratio``."""
    s = step.to(torch.float32)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    else:
        decay = torch.ones_like(s)
    return cfg.lr * warm * decay


def init_adam(params: Any) -> AdamState:
    """Zero fp32 moments beside each param, on its device; step 0."""
    leaves = named_leaves(params)
    dev = leaves[0][1].device if leaves else torch.device("cpu")

    def zeros(_, p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     m=map_with_names(zeros, params),
                     v=map_with_names(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (in sorted-path order) of each leaf's
    fp32 sum of squares."""
    sq = [torch.sum(torch.square(t.to(torch.float32)))
          for _, t in named_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm), norm); each grad keeps
    its dtype."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return map_with_names(
        lambda _, g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: AdamState
                 ) -> Tuple[Any, AdamState, dict]:
    """One AdamW step, in place: the params and the moments are updated
    where they live and returned. Moments fp32, update computed in fp32
    and cast back to each param's dtype. Metrics: lr and the gradient's
    global norm before clipping."""
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    g_leaves = dict(named_leaves(grads))
    m_leaves = dict(named_leaves(state.m))
    v_leaves = dict(named_leaves(state.v))
    for name, p in named_leaves(params):
        g32 = g_leaves[name].to(torch.float32)
        m, v = m_leaves[name], v_leaves[name]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g32)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g32))
        del g32
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    return params, AdamState(step, state.m, state.v), {"lr": lr,
                                                      "grad_norm": gnorm}
