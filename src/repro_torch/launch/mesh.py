"""The 1-D tensor-parallel mesh of sharded serving (port of
``repro.launch.mesh.make_tp_mesh``).

The reference is single-controller: one Python process drives every
shard through ``shard_map``, so the engine's scheduler, clock and
admission decisions exist once. The port keeps that design: a
``TPMesh`` is a list of devices driven by one process, and each shard's
weights and page pools live on its own device. Several shards may sit
on one device (``TPMesh([dev] * n)``), as the reference's virtual host
devices do; the shard-local kernels then run at their shard-local
shapes on that device, and the collectives move nothing across cards.

The two collectives are the only ones the reference uses, gathered or
summed on the lead device (``devices[0]``), where the replicated
activations live.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch._device import DeviceLike, resolve_device


class TPMesh:
    """``devices[i]`` holds shard i; the axis is named ``"tp"``."""

    axis_name = "tp"

    def __init__(self, devices: Sequence[DeviceLike]):
        if not devices:
            raise ValueError("TPMesh needs at least one device")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def all_gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """Concatenate the shards' parts along ``dim`` on the lead device."""
        return torch.cat([p.to(self.lead) for p in parts], dim=dim)

    def psum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum the shards' parts on the lead device, in shard order: int32
        accumulators (which add exactly) and the data-parallel EF trace's
        per-block fp32 sums."""
        acc = parts[0].to(self.lead)
        for p in parts[1:]:
            acc = acc + p.to(self.lead)
        return acc


def make_tp_mesh(tp: int, device: DeviceLike = None) -> TPMesh:
    """The mesh of ``EngineConfig(mesh=...)`` and ``serve(tp=...)``: on
    CUDA (the default) the cards ``cuda:0 .. cuda:tp-1``, raising when
    the host has fewer; on ``device="cpu"`` tp shards on the CPU, the
    counterpart of the reference's virtual host devices."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        return TPMesh([dev] * tp)
    n = torch.cuda.device_count()
    if tp > n:
        raise ValueError(
            f"tp={tp} needs {tp} CUDA devices but this host has {n}; to "
            f"place {tp} shards on one card build the mesh explicitly with "
            f"TPMesh([torch.device('cuda:0')] * {tp})")
    return TPMesh([torch.device("cuda", i) for i in range(tp)])
