"""Logical-axis sharding rules (port of ``repro.models.partition``,
:1-76).

Model code names the logical axes of an intermediate; the active
``Rules`` maps them to mesh axes (None: replicated). The step builders
of ``launch.steps`` set the rules (``use_rules``); outside a rules
context ``constrain`` is a no-op.

The port keeps activations replicated within a data row between blocks,
as its tensor-parallel serving does (``models.context.MeshContext``):
under rules ``constrain`` checks the tensor's rank, as the reference
does, and moves no data. So a rules table that shards ``seq`` over
"model" (``ShardOptions(seq_parallel=True)``) changes neither the
numbers nor the memory here.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import Mesh, NamedSharding, PartitionSpec as P

MeshAxes = Union[None, str, Tuple[str, ...]]

_state = threading.local()


class Rules:
    def __init__(self, mesh: Mesh, table: Dict[str, MeshAxes]):
        self.mesh = mesh
        self.table = dict(table)

    def spec(self, logical_axes: Sequence[Optional[str]]) -> P:
        used = set()
        out = []
        for ax in logical_axes:
            if ax is None:
                out.append(None)
                continue
            mesh_ax = self.table.get(ax)
            if mesh_ax is None:
                out.append(None)
                continue
            parts = (mesh_ax,) if isinstance(mesh_ax, str) else tuple(mesh_ax)
            # one mesh axis may shard only one dim of a given tensor
            if any(p in used for p in parts):
                out.append(None)
            else:
                used.update(parts)
                out.append(mesh_ax)
        return P(*out)

    def sharding(self, logical_axes: Sequence[Optional[str]]) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical_axes))


def current_rules() -> Optional[Rules]:
    return getattr(_state, "rules", None)


@contextmanager
def use_rules(rules: Optional[Rules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Check the rank against the active rules and return ``x`` as it
    is (activations stay replicated within a data row); a no-op
    outside rules."""
    if current_rules() is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"{len(logical_axes)} axes for rank-{x.ndim} tensor")
    return x
