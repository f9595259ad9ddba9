"""Hessian-trace estimation (port of ``repro.core.hessian``; the
HAWQ-V2 baseline FIT is compared against).

Hutchinson estimator with Rademacher probes:
    Tr(H) ≈ (1/m) Σ_i r_iᵀ H r_i,   Var = 2(||H||_F² − Σ H_ii²)  (Prop. 6)

Per-block traces use the restriction r_lᵀ(Hr)_l, whose expectation is
Tr(H_ll). Hessian-vector products are reverse-over-reverse: the
gradient is taken with ``create_graph=True`` and differentiated again
along the probe, so every op of the fp forward needs only a double
backward (no forward-mode formula). The reference's ``key`` is a
``torch.Generator`` here; the probes of one seed are the same on every
run.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.fisher import _grad_leaves
from repro_torch.utils.pytree import map_with_names, named_leaves

LossFn = Callable[[Any, Any], torch.Tensor]


def _grad_graph(loss_fn: LossFn, params: Any, batch: Any
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(leaves requiring grad in block order, their gradients with a graph
    of their own)."""
    named, p = _grad_leaves(params)
    leaves = list(named.values())
    grads = torch.autograd.grad(loss_fn(p, batch), leaves, create_graph=True,
                                allow_unused=True)
    return leaves, [torch.zeros_like(leaf) if g is None else g
                    for leaf, g in zip(leaves, grads)]


def _grad_of(out: torch.Tensor, leaves: List[torch.Tensor],
             retain_graph: bool = False) -> List[torch.Tensor]:
    if not out.requires_grad:       # the gradient does not depend on θ
        return [torch.zeros_like(leaf) for leaf in leaves]
    got = torch.autograd.grad(out, leaves, retain_graph=retain_graph,
                              allow_unused=True)
    return [torch.zeros_like(leaf) if g is None else g
            for leaf, g in zip(leaves, got)]


def hvp(loss_fn: LossFn, params: Any, batch: Any, vec: Any) -> Any:
    """H·v (a tree like ``params``): the gradient of (∇θ f · v)."""
    leaves, grads = _grad_graph(loss_fn, params, batch)
    vs = [v for _, v in named_leaves(vec)]
    dot = sum(torch.sum(g * v.to(g.dtype)) for g, v in zip(grads, vs))
    hv = dict(zip([name for name, _ in named_leaves(params)],
                  _grad_of(dot, leaves)))
    return map_with_names(lambda name, _: hv[name], params)


def rademacher_like(params: Any, key: torch.Generator) -> Any:
    """±1 fp32 probes shaped like ``params``, drawn from ``key`` in block
    order (on the generator's device)."""
    return map_with_names(
        lambda _, leaf: torch.empty(leaf.shape, dtype=torch.float32,
                                    device=key.device
                                    ).bernoulli_(0.5, generator=key) * 2.0 - 1.0,
        params)


def hutchinson_block_traces(loss_fn: LossFn, params: Any, batch: Any,
                            key: torch.Generator, iters: int = 64
                            ) -> Tuple[Dict[str, float], Dict[str, np.ndarray]]:
    """Per-block Hessian traces of the fp32 model. Returns (mean traces,
    per-probe samples)."""
    p32 = map_with_names(lambda _, a: a.to(torch.float32), params)
    names = [name for name, _ in named_leaves(p32)]
    rows = []
    for _ in range(iters):
        r = rademacher_like(p32, key)
        hr = hvp(loss_fn, p32, batch, r)
        rows.append(torch.stack([torch.sum(rl * hl) for (_, rl), (_, hl)
                                 in zip(named_leaves(r), named_leaves(hr))]))
    samples = torch.stack(rows).cpu().numpy().astype(np.float64)  # (iters, blocks)
    return ({name: float(np.mean(samples[:, j])) for j, name in enumerate(names)},
            {name: samples[:, j] for j, name in enumerate(names)})


def exact_block_traces(loss_fn: LossFn, params: Any, batch: Any
                       ) -> Dict[str, float]:
    """Exact per-block Hessian traces of the fp32 model, one Hessian row
    (H·e_i) per parameter: O(P) backward passes — tests/tiny models only."""
    p32 = map_with_names(lambda _, a: a.to(torch.float32), params)
    leaves, grads = _grad_graph(loss_fn, p32, batch)
    out: Dict[str, float] = {}
    for (name, _), leaf, g in zip(named_leaves(p32), leaves, grads):
        gf = g.reshape(-1)
        diag = [_grad_of(gf[i], [leaf], retain_graph=True)[0].reshape(-1)[i]
                for i in range(gf.numel())]
        # tiny models and tests only; no kernel or serving path
        # rpr-ok: RPR003 the exact trace's host-side fold
        out[name] = float(torch.sum(torch.stack(diag).to(torch.float64)))
    return out
