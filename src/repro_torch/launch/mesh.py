"""Meshes (port of ``repro.launch.mesh``): the 1-D tensor-parallel
``TPMesh`` of sharded serving (``make_tp_mesh``), and the named-axis
``Mesh`` of sharded training, prefill and decode (``make_mesh``), with
the partition specs, named shardings and sharded tensors that lay
tensors out on it.

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

from contextlib import contextmanager
from typing import Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
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


# ---------------------------------------------------------------------------
# the (data, model) mesh of sharded training, prefill and decode
# ---------------------------------------------------------------------------
#
# Port of ``repro.launch.mesh.{make_mesh, make_production_mesh,
# small_test_mesh}`` (:25-43) and of the placement types the reference
# takes from its array library (a partition spec, a named sharding and a
# value laid out by one). Single-controller like ``TPMesh``: one process
# holds a grid of devices, each shard's part lives on its device, and a
# collective is a torch computation over the parts (``.to``, ``cat``,
# adds), so autograd differentiates through it. A shard is named by its
# coordinate, a tuple with one index an axis.

Coord = Tuple[int, ...]
Axes = Union[str, Sequence[str]]


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), a mesh axis name, or a
    tuple of axis names (the dim split over their product, row-major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _entry(e):
    """A spec entry in its normal form: a one-axis tuple is the axis."""
    if isinstance(e, (list, tuple)):
        e = tuple(e)
        return e[0] if len(e) == 1 else (e or None)
    return e


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Mesh:
    """Named axes over a grid of devices. ``shape`` is the ordered
    ``{axis: size}`` dict; ``devices`` an object array of that shape.
    ``recorder`` (e.g. ``utils.hlo.CollectiveStats``) receives
    ``add(kind, nbytes, group_size)`` for every collective of more than
    one shard in which the origin shard (0, ..., 0) takes part, with the
    bytes of that shard's output: that shard's per-device collective
    ledger."""

    def __init__(self, devices, axes: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(given[idx])
        axes = tuple(axes)
        if grid.ndim != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"a mesh of shape {grid.shape} needs "
                             f"{grid.ndim} distinct axis names, got {axes}")
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = grid
        self.axis_names = axes
        self.shape: Dict[str, int] = dict(zip(axes, grid.shape))
        self.recorder = None
        # told of every collective result that shards on one device share
        # (``launch.dryrun``: each shard would hold a copy of it)
        self.share_observer = None

    @classmethod
    def on_device(cls, shape: Sequence[int], axes: Sequence[str],
                  device: DeviceLike) -> "Mesh":
        """Every shard on one device (several shards on one card)."""
        grid = np.empty(tuple(shape), dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(device)
        return cls(grid, axes)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, lead={self.lead})"

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        return self.devices.flat[0]

    @property
    def origin(self) -> Coord:
        return (0,) * len(self.axis_names)

    def coords(self) -> List[Coord]:
        """Every shard's coordinate, row-major (shard order)."""
        return [tuple(c) for c in np.ndindex(self.devices.shape)]

    def device(self, coord: Coord) -> torch.device:
        return self.devices[tuple(coord)]

    @contextmanager
    def recording(self, recorder):
        """Send this mesh's collectives to ``recorder`` inside the block."""
        prev, self.recorder = self.recorder, recorder
        try:
            yield recorder
        finally:
            self.recorder = prev

    # -- groups ------------------------------------------------------------
    def _axis_ids(self, axes: Axes) -> Tuple[int, ...]:
        names = spec_axes(axes)
        missing = [a for a in names if a not in self.shape]
        if missing:
            raise ValueError(f"axes {missing} are not in mesh {self.shape}")
        return tuple(self.axis_names.index(a) for a in names)

    def axis_size(self, axes: Axes) -> int:
        return int(np.prod([self.shape[a] for a in spec_axes(axes)] or [1]))

    def axis_index(self, axes: Axes, coord: Coord) -> int:
        """The shard's index along ``axes`` (row-major over a tuple)."""
        idx = 0
        for a in spec_axes(axes):
            idx = idx * self.shape[a] + coord[self.axis_names.index(a)]
        return idx

    def groups(self, coords: Sequence[Coord], axes: Axes) -> List[List[Coord]]:
        """``coords`` split into the groups of a collective over ``axes``:
        shards that differ only along ``axes``, each group in shard order
        along ``axes``. Every group must be whole."""
        ids = self._axis_ids(axes)
        out: Dict[Coord, List[Coord]] = {}
        for c in coords:
            key = tuple(v for i, v in enumerate(c) if i not in ids)
            out.setdefault(key, []).append(tuple(c))
        n = self.axis_size(axes)
        groups = []
        for key in sorted(out):
            g = sorted(out[key], key=lambda c: self.axis_index(axes, c))
            if len(g) != n:
                raise ValueError(f"a collective over {axes} needs {n} shards "
                                 f"a group, got {len(g)}")
            groups.append(g)
        return groups

    def _record(self, kind: str, nbytes: int, group_size: int,
                coords) -> None:
        # a group of one moves nothing: no entry
        if self.recorder is not None and group_size > 1 and self.origin in coords:
            self.recorder.add(kind, int(nbytes), group_size)

    def _per_device(self, group: List[Coord], make) -> Dict[Coord, torch.Tensor]:
        """``make(device)`` once a distinct device of ``group``, shared by
        the group's shards on that device."""
        cache: Dict[torch.device, torch.Tensor] = {}
        out = {}
        for c in group:
            d = self.device(c)
            if d not in cache:
                cache[d] = make(d)
            out[c] = cache[d]
        if self.share_observer is not None and len(cache) < len(out):
            self.share_observer(out)
        return out

    # -- collectives ---------------------------------------------------------
    def all_gather(self, parts: Mapping[Coord, torch.Tensor], axes: Axes,
                   dim: int = 0, tiled: bool = True) -> Dict[Coord, torch.Tensor]:
        """Each shard gets its group's parts concatenated along ``dim``
        (stacked on a new ``dim`` when not ``tiled``), in shard order."""
        out: Dict[Coord, torch.Tensor] = {}
        join = torch.cat if tiled else torch.stack
        for g in self.groups(list(parts), axes):
            out.update(self._per_device(
                g, lambda d, g=g: join([parts[c].to(d) for c in g], dim=dim)))
        first = out[next(iter(parts))]
        self._record("all-gather", _nbytes(first), self.axis_size(axes), parts)
        return out

    def psum(self, parts: Mapping[Coord, torch.Tensor], axes: Axes
             ) -> Dict[Coord, torch.Tensor]:
        """Each shard gets its group's sum, folded left to right in shard
        order."""
        out = self._reduce(parts, axes, torch.add)
        self._record("all-reduce", _nbytes(next(iter(parts.values()))),
                     self.axis_size(axes), parts)
        return out

    def pmean(self, parts: Mapping[Coord, torch.Tensor], axes: Axes
              ) -> Dict[Coord, torch.Tensor]:
        """``psum`` over ``axes`` divided by the group size."""
        n = self.axis_size(axes)
        out = self._reduce(parts, axes, torch.add, finish=lambda t: t / n)
        self._record("all-reduce", _nbytes(next(iter(parts.values()))), n, parts)
        return out

    def pmax(self, parts: Mapping[Coord, torch.Tensor], axes: Axes
             ) -> Dict[Coord, torch.Tensor]:
        out = self._reduce(parts, axes, torch.maximum)
        self._record("all-reduce", _nbytes(next(iter(parts.values()))),
                     self.axis_size(axes), parts)
        return out

    def psum_scatter(self, parts: Mapping[Coord, torch.Tensor], axes: Axes,
                     dim: int = 0, tiled: bool = True
                     ) -> Dict[Coord, torch.Tensor]:
        """The group's sum split along ``dim``: the i-th shard along
        ``axes`` gets chunk i (index i of ``dim`` when not ``tiled``)."""
        summed = self._reduce(parts, axes, torch.add)
        n = self.axis_size(axes)
        out = {}
        for c, t in summed.items():
            i = self.axis_index(axes, c)
            if tiled:
                if t.shape[dim] % n:
                    raise ValueError(f"psum_scatter: dim {dim} of size "
                                     f"{t.shape[dim]} does not split {n} ways")
                out[c] = t.chunk(n, dim=dim)[i]
            else:
                out[c] = t.select(dim, i)
        self._record("reduce-scatter", _nbytes(out[next(iter(parts))]), n, parts)
        return out

    def ppermute(self, parts: Mapping[Coord, torch.Tensor], axis: str,
                 perm: Sequence[Tuple[int, int]]) -> Dict[Coord, torch.Tensor]:
        """Shard ``src`` along ``axis`` sends its part to ``dst`` for every
        (src, dst) of ``perm``; a shard that receives nothing gets zeros."""
        ax = self._axis_ids(axis)[0]
        dst_of = dict(perm)
        out: Dict[Coord, torch.Tensor] = {}
        for c, t in parts.items():
            if c[ax] in dst_of:
                dst = c[:ax] + (dst_of[c[ax]],) + c[ax + 1:]
                out[dst] = t.to(self.device(dst))
        for c, t in parts.items():
            if c not in out:
                out[c] = torch.zeros_like(t)
        self._record("collective-permute", _nbytes(next(iter(parts.values()))),
                     self.shape[axis], parts)
        return out

    def _reduce(self, parts, axes, op, finish=None) -> Dict[Coord, torch.Tensor]:
        out: Dict[Coord, torch.Tensor] = {}
        for g in self.groups(list(parts), axes):
            def fold(d, g=g):
                acc = parts[g[0]].to(d)
                for c in g[1:]:
                    acc = op(acc, parts[c].to(d))
                return finish(acc) if finish is not None else acc
            out.update(self._per_device(g, fold))
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class NamedSharding:
    """A mesh and a partition spec: where each part of a tensor lives."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    def slices(self, shape: Sequence[int], coord: Coord) -> Tuple[slice, ...]:
        """The index of shard ``coord``'s part of a tensor of ``shape``."""
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        if len(spec) > len(shape):
            raise ValueError(f"spec {self.spec!r} has more entries than "
                             f"shape {tuple(shape)}")
        out = []
        for n, entry in zip(shape, spec):
            k = self.mesh.axis_size(entry)
            if n % k:
                raise ValueError(f"dim of size {n} does not split over "
                                 f"{entry!r} ({k} shards)")
            i, step = self.mesh.axis_index(entry, coord), n // k
            out.append(slice(i * step, (i + 1) * step))
        return tuple(out)

    def part_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(s.stop - s.start
                     for s in self.slices(shape, self.mesh.origin))


class ShardedTensor:
    """A tensor laid out by a ``NamedSharding``: ``parts[coord]`` is shard
    ``coord``'s slice, on its device. Replicated dims give equal parts
    that are distinct tensors (each shard updates its own in place)."""

    def __init__(self, sharding: NamedSharding, parts: Dict[Coord, torch.Tensor],
                 shape: Sequence[int]):
        self.sharding = sharding
        self.parts = parts
        self.shape = torch.Size(shape)

    def __repr__(self) -> str:
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding!r})")

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.parts.values())).dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def axis_dim(self, axis: str):
        """The dim split over mesh axis ``axis`` (None: none is)."""
        for i, entry in enumerate(tuple(self.sharding.spec)):
            if axis in spec_axes(entry):
                return i
        return None

    def full(self, device: DeviceLike = None) -> torch.Tensor:
        """The whole tensor assembled on ``device`` (default: the mesh's
        lead device), read from the first shard holding each slice."""
        dev = self.mesh.lead if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        seen = set()
        for c in self.mesh.coords():
            idx = self.sharding.slices(self.shape, c)
            key = tuple((s.start, s.stop) for s in idx)
            if key not in seen:
                seen.add(key)
                out[idx] = self.parts[c].detach().to(dev)
        return out


def place_tensor(t: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """Lay ``t`` out by ``sharding``: every shard gets its own copy of
    its slice on its device."""
    parts = {}
    for c in sharding.mesh.coords():
        part = t.detach()[sharding.slices(t.shape, c)]
        dev = sharding.mesh.device(c)
        parts[c] = part.to(dev, copy=True).contiguous()
    return ShardedTensor(sharding, parts, t.shape)


# ---------------------------------------------------------------------------
# placing trees (the step functions' argument placement)
# ---------------------------------------------------------------------------

def _zip_map(fn, tree, shardings):
    """``fn(leaf, sharding)`` over ``tree``; ``shardings`` has the tree's
    structure, or one sharding stands for a whole subtree."""
    if tree is None:
        return None
    if isinstance(shardings, NamedSharding) and isinstance(tree, (dict, list, tuple)):
        return _zip_map(fn, tree, _broadcast(tree, shardings))
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, a, b) for a, b in zip(tree, shardings)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, a, b) for a, b in zip(tree, shardings))
    return fn(tree, shardings)


def _broadcast(tree, sharding):
    if isinstance(tree, dict):
        return {k: _broadcast(v, sharding) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_broadcast(v, sharding) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_broadcast(v, sharding) for v in tree)
    return sharding


def place(tree: Any, shardings: Any) -> Any:
    """Lay every tensor of ``tree`` out by its ``NamedSharding``: a tree
    of ``launch.mesh.ShardedTensor``s. A leaf already laid out by an
    equal sharding stays as it is; a sharding of None leaves its leaf
    alone."""
    def one(leaf, sh):
        if sh is None or not isinstance(leaf, (torch.Tensor, ShardedTensor)):
            return leaf
        if isinstance(leaf, ShardedTensor):
            if leaf.sharding == sh:
                return leaf
            leaf = leaf.full()
        return place_tensor(leaf, sh)

    return _zip_map(one, tree, shardings)


def gather(tree: Any, device: DeviceLike = None) -> Any:
    """Assemble every ``ShardedTensor`` of ``tree`` whole on ``device``
    (default: its mesh's lead device)."""
    def rec(node):
        if isinstance(node, ShardedTensor):
            return node.full(device)
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(rec(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return node

    return rec(tree)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: DeviceLike = None) -> Mesh:
    """A mesh of ``prod(shape)`` shards over ``axes``: on CUDA (the
    default) the cards ``cuda:0 .. n-1``, raising when the host has fewer
    (several shards on one card: ``Mesh.on_device``); on ``device="cpu"``
    every shard on the CPU."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    dev = resolve_device(device)
    if dev.type != "cuda":
        return Mesh.on_device(shape, axes, dev)
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(
            f"a {shape} mesh needs {n} CUDA devices but this host has "
            f"{have}; to place its shards on one card build it with "
            f"Mesh.on_device({shape}, {tuple(axes)}, 'cuda:0')")
    grid = np.empty(shape, dtype=object)
    for i, idx in enumerate(np.ndindex(shape)):
        grid[idx] = torch.device("cuda", i)
    return Mesh(grid, axes)


def make_production_mesh(multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def small_test_mesh(data: int = 2, model: int = 4,
                    device: DeviceLike = None) -> Mesh:
    return make_mesh((data, model), ("data", "model"), device)
