"""Shape-only dry run (port of ``repro.launch.dryrun``) + roofline terms.

The reference lowers and compiles each (arch x shape x mesh) cell on 512
forced host devices and reads XLA's cost analysis, memory analysis and
HLO. The port has no compiler: it builds the same step
(``launch.steps.build_step``) on a production-shaped mesh whose every
shard is on PyTorch's ``meta`` device and runs it once on the step's
meta stand-ins. Nothing is allocated and nothing is computed: every op
only propagates shapes and dtypes. The run needs no card and takes no
device argument; an op that would produce a real (CPU or CUDA) tensor
with any element raises (``_Ledger``). The kernel wrappers the steps reach take their
shape-only route on meta tensors (``kernels.paged_attention.attend``).

The run is watched by two things together:

  * ``_Ledger``, a ``TorchDispatchMode``: FLOPs by
    ``torch.utils.flop_counter``'s per-op formulas (``flop_registry``,
    what ``FlopCounterMode`` counts, without its decompositions, which
    would run every meta op through Python), every op's input and
    output bytes (views excluded; the counterpart of XLA's "bytes
    accessed"), and the live bytes of the storages the run makes, freed
    on a weakref finalizer of the storage (views share one);
  * ``mesh.recording(CollectiveStats())``: the origin shard's collective
    ledger (``launch.mesh.Mesh``).

Per-chip attribution. The step is single-controller: one process runs
each data row in turn (forward and backward of a row, its activations
freed before the next), and a row's replicated work sits on its lead
shard, so "per chip" is a definition. Here it is:

  * FLOPs and bytes accessed: the whole mesh's run divided by the chips
    (the average shard);
  * ``temp_bytes``: the origin row's peak. The ledger marks the rows
    (``steps.ROW_OBSERVERS``); a storage made in a row is counted as its
    row's shards' (chips / rows of them, evenly: a lead's replicated
    activations are spread over its row), one made outside the rows (the
    gradient sync, AdamW) as every shard's (÷ chips); storages of the
    other rows are the other rows' chips' and left out. A collective's
    result that shards on one device share (``Mesh.share_observer``)
    counts once for each of them, as each would hold a copy. So the
    origin shard's figure does not move with the data axis at a fixed
    batch a row (tested). A lead that keeps its row's activations replicated holds up to
    its row's width times more; ``temp_bytes_run`` (the run's undivided
    peak) is what one card holding every shard needs beside the
    arguments;
  * ``argument_bytes``, ``output_bytes``, ``alias_bytes``: the origin
    shard's own parts, exactly (``NamedSharding.part_shape``): the
    placed arguments, the outputs, and the outputs that are arguments
    updated in place (caches, SSM states, AdamW state);
  * the collective ledger: the origin shard's (the mesh's recorder).

On a (1,1) mesh every per-chip figure equals its total.

Cost protocol. As in the reference, a cell runs the full-depth step
once (memory and coherence: the step builds, lays its arguments out and
runs at every shard) and then the cost pair of ``_cost_pair`` (one and
two layers, or periods), extrapolated linearly in depth to the FLOPs,
bytes and ledger (``pair_terms``). XLA needs the pair because it counts
a scan body once; the port's Python loops count every layer, and at
smoke size the extrapolated FLOPs, bytes and ledger equal the full-depth
run's exactly (``tests/test_torch_dryrun.py``). The temp peak does not
extrapolate: it is the largest of several terms linear in depth (the
head's logits at a shallow depth, the saved activations of every layer
at a deep one), so the peak moves with depth and a line through the
pair misses it either way. So memory is the full-depth run's, which
costs about depth/2 x 20 s of host time at 256 shards (llama3_8b's
``train_4k``). The reference's second FLOPs pair at ``chunk=seq_len`` is
not needed: the port's chunked attention counts every chunk, and its
FLOPs at ``chunk=seq_len`` equal those at the real chunk (tested).

Results land in experiments/dryrun_torch/<cell>.json, with the
reference's keys and file names.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3_8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
import traceback
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, SHAPES, ModelConfig, ShapeSpec, get_config
from repro_torch.launch.mesh import ShardedTensor, make_production_mesh, place
from repro_torch.launch.roofline import RooflineTerms, model_flops, param_counts
from repro_torch.launch.sharding import ShardOptions
from repro_torch.launch.steps import ROW_OBSERVERS, build_step
from repro_torch.utils.hlo import CollectiveStats

log = logging.getLogger("repro_torch.dryrun")
OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def _cost_pair(cfg: ModelConfig, shape: ShapeSpec,
               chunk: Optional[int] = None
               ) -> Tuple[ModelConfig, ModelConfig, float]:
    """Two unrolled configs (n1, n2 units) + extrapolation multiplier M,
    so that n1 + M·(n2 − n1) is the real depth: one and two layers, or
    the hybrid's one and two attention periods plus its remainder.
    ``chunk`` overrides ``attn_chunk``."""
    kw = {"scan_layers": False}
    if chunk is not None:
        kw["attn_chunk"] = chunk
    if cfg.family == "hybrid":
        period = cfg.attn_period
        n_groups, rest = divmod(cfg.num_layers, period)
        c1 = dataclasses.replace(cfg, num_layers=1 * period + rest, **kw)
        c2 = dataclasses.replace(cfg, num_layers=2 * period + rest, **kw)
        return c1, c2, float(n_groups - 2)
    c1 = dataclasses.replace(cfg, num_layers=1, **kw)
    c2 = dataclasses.replace(cfg, num_layers=2, **kw)
    return c1, c2, float(cfg.num_layers - 2)


def meta_mesh(multi_pod: bool = False):
    """``make_production_mesh``'s (16, 16) or (2, 16, 16) mesh with every
    shard on ``meta``."""
    return make_production_mesh(multi_pod, device="meta")


def _lower(cfg: ModelConfig, shape: ShapeSpec, mesh, opts: ShardOptions):
    """The step and its meta stand-ins (the reference's lowering)."""
    if any(d.type != "meta" for d in mesh.devices.flat):
        raise ValueError(f"the dry run needs a mesh on meta, got {mesh}")
    return build_step(cfg, shape, mesh, opts)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(x) -> list:
    """The tensors of a nest of tuples, lists and dicts (called on every
    op's arguments: pytree's ``tree_leaves`` costs several times more)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


class _Ledger(TorchDispatchMode):
    """Bytes accessed, and the live storages the run makes: an event
    list of (storage id, +bytes) at each output of an op that allocates
    (not a view, not in place) and (storage id, −bytes) when the storage
    dies, however many views it had (a finalizer on the storage). Each
    storage keeps the row it was made in (``mark``, a
    ``steps.ROW_OBSERVERS`` entry; None outside the rows). Raises on an
    op that makes a non-empty tensor off ``meta``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.events = []
        self.rows: Dict[int, Optional[int]] = {}    # storage id -> its row
        self.copies: Dict[int, int] = {}    # storage id -> shards sharing it
        self.n_rows = 0
        self._row: Optional[int] = None
        self.live: Dict[int, int] = {}      # storage address -> id
        self._ops: Dict = {}    # op -> (FLOP formula, is a view, aliases an input)
        self._finalizers = []
        self._open = True

    def mark(self, lead) -> None:
        """A row starts (its lead), or the rows are over (None)."""
        if lead is None:
            self._row = None
        else:
            self._row, self.n_rows = self.n_rows, self.n_rows + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        info = self._ops.get(func)
        if info is None:
            info = self._ops[func] = (
                flop_registry.get(func._overloadpacket), func.is_view,
                any(r.alias_info is not None for r in func._schema.returns))
        count, is_view, aliased = info
        outs = _tensors(out)
        for t in outs:
            # an empty tensor holds nothing to compute on (autograd's
            # checkpoint makes one on the CPU as a marker)
            if t.device.type != "meta" and t.numel():
                raise RuntimeError(f"dry run: {func} made a tensor on {t.device}")
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if not is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
        if aliased:
            return out                      # a view or an in-place result
        for t in outs:
            st = t.untyped_storage()
            k = st._cdata
            if k in self.live:
                continue
            uid, n = len(self.events), st.nbytes()
            self.live[k] = uid
            self.events.append((uid, n))
            self.rows[uid] = self._row
            self._finalizers.append(weakref.finalize(st, self._free, k, uid, n))
        return out

    def shared(self, parts) -> None:
        """``Mesh.share_observer``: a collective's result, one storage
        shared by the shards of a group on one device."""
        n = {}
        for t in parts.values():
            n[_key(t)] = n.get(_key(t), 0) + 1
        for k, c in n.items():
            uid = self.live.get(k)
            if uid is not None:
                self.copies[uid] = max(self.copies.get(uid, 1), c)

    def _free(self, k: int, uid: int, n: int) -> None:
        if self._open:
            self.events.append((uid, -n))
            if self.live.get(k) == uid:
                del self.live[k]

    def ids(self, tensors) -> set:
        """The storage ids of those of ``tensors`` the run made."""
        return {self.live[_key(t)] for t in tensors if _key(t) in self.live}

    def close(self) -> None:
        self._open = False
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()

    def peak(self, exclude=(), origin_row: bool = False) -> int:
        """The most bytes live at once, the storages in ``exclude`` (the
        outputs) left out. ``origin_row``: the most that the origin row's
        shards hold at once, × chips: a storage counted once for each
        shard that shares it (``shared``), those made in the first row
        (the origin's) × rows, as its shards' alone, those made outside
        the rows as every shard's, the other rows' left out."""
        live = top = 0
        for k, d in self.events:
            if k in exclude:
                continue
            if origin_row:
                row = self.rows[k]
                d *= self.copies.get(k, 1) * (
                    1 if row is None else self.n_rows if row == 0 else 0)
            live += d
            top = max(top, live)
        return top


def _placed_args(build):
    """The step's arguments laid out by its shardings where the step
    places them itself (the parameters, optimizer and decode state); the
    batch stays whole, as the step slices it."""
    n_placed = len(build.args) - 1
    return tuple(place(a, s) for a, s in zip(build.args[:n_placed],
                                             build.shardings[:n_placed])) \
        + tuple(build.args[n_placed:])


def origin_bytes(tree, shardings=None, every_shard: bool = False) -> int:
    """Bytes of the origin shard's parts of ``tree`` (``every_shard``: of
    every shard's parts): a ``ShardedTensor``'s parts, a plain tensor's
    parts under ``shardings`` (the tree's structure, or None: the whole
    tensor, once)."""
    total = 0

    def rec(node, sh):
        nonlocal total
        if isinstance(node, ShardedTensor):
            n = _nbytes(node.parts[node.mesh.origin])
            total += n * (len(node.parts) if every_shard else 1)
        elif isinstance(node, torch.Tensor):
            if sh is None:
                total += _nbytes(node)
            else:
                n = int(np.prod(sh.part_shape(node.shape))) * node.element_size()
                total += n * (sh.mesh.size if every_shard else 1)
        elif isinstance(node, dict):
            for k, v in node.items():
                rec(v, None if sh is None else sh[k])
        elif isinstance(node, (list, tuple)):
            if sh is None or hasattr(sh, "part_shape"):
                sh = [sh] * len(node)
            for v, s in zip(node, sh):
                rec(v, s)

    rec(tree, shardings)
    return total


def argument_bytes(build) -> int:
    """The origin shard's parts of every argument, by the step's
    shardings (analytic: nothing runs)."""
    return origin_bytes(build.args, build.shardings)


def _origin_parts(tree) -> Dict[int, int]:
    """storage -> bytes of every origin part and plain tensor in ``tree``."""
    out = {}
    for leaf in tree_leaves(tree, is_leaf=lambda x: isinstance(x, ShardedTensor)):
        t = leaf.parts[leaf.mesh.origin] if isinstance(leaf, ShardedTensor) else leaf
        if isinstance(t, torch.Tensor):
            out[_key(t)] = _nbytes(t)
    return out


def _analyze(build) -> Dict:
    """Run ``build.fn`` once on its meta stand-ins: the reference's keys
    (its ``f32_as_bf16`` parser switch has no counterpart: the ledger
    records the step's own dtypes), and the run's totals and output
    shapes."""
    mesh = build.rules.mesh
    chips = mesh.size
    args = _placed_args(build)
    for leaf in tree_leaves(args, is_leaf=lambda x: isinstance(x, ShardedTensor)):
        parts = leaf.parts.values() if isinstance(leaf, ShardedTensor) else [leaf]
        if any(isinstance(t, torch.Tensor) and not t.is_meta for t in parts):
            raise ValueError("the dry run takes meta stand-ins only")
    in_keys = _origin_parts(args)
    stats = CollectiveStats()
    ledger = _Ledger()
    ROW_OBSERVERS.append(ledger.mark)
    mesh.share_observer = ledger.shared
    try:
        with mesh.recording(stats), ledger:
            out = build.fn(*args)
        out_parts = _origin_parts(out)
        outs = ledger.ids(_output_tensors(out))
        temp_run = ledger.peak(exclude=outs)
        temp_origin = ledger.peak(exclude=outs, origin_row=True) / chips
    finally:
        ROW_OBSERVERS.remove(ledger.mark)
        mesh.share_observer = None
        ledger.close()
    total_flops = float(ledger.flops)
    mem = {
        "argument_bytes": argument_bytes(build),
        "output_bytes": sum(out_parts.values()),
        "temp_bytes": temp_origin,
        "alias_bytes": sum(n for k, n in out_parts.items() if k in in_keys),
    }
    return {
        "flops": total_flops / chips,
        "bytes": ledger.bytes / chips,
        "coll": stats,
        "mem": mem,
        "collective_counts": stats.count_by_kind,
        "totals": {"flops": total_flops, "bytes": float(ledger.bytes),
                   "temp_bytes_run": temp_run},
        "output_shapes": _shapes(out),
    }


def _output_tensors(out) -> list:
    """Every tensor of ``out``, each part of a ``ShardedTensor``."""
    ts = []
    for leaf in tree_leaves(out, is_leaf=lambda x: isinstance(x, ShardedTensor)):
        ts.extend(leaf.parts.values() if isinstance(leaf, ShardedTensor) else [leaf])
    return [t for t in ts if isinstance(t, torch.Tensor)]


def _shapes(out):
    """Output shapes and dtypes, for comparing a meta run with a real one."""
    return [(tuple(t.shape), t.dtype) for t in tree_leaves(
        out, is_leaf=lambda x: isinstance(x, ShardedTensor))
        if isinstance(t, (torch.Tensor, ShardedTensor))]


def _extrapolate(a1: Dict, a2: Dict, mult: float, key: str) -> float:
    return a2[key] + (a2[key] - a1[key]) * mult


def pair_terms(cfg: ModelConfig, shape: ShapeSpec, mesh,
               opts: ShardOptions = ShardOptions()) -> Dict:
    """The cost pair of ``cfg`` run on ``mesh`` and extrapolated to its
    depth: FLOPs, bytes and the ledger a chip, and their roofline
    terms."""
    c1, c2, mult = _cost_pair(cfg, shape)
    a1 = _analyze(_lower(c1, shape, mesh, opts))
    a2 = _analyze(_lower(c2, shape, mesh, opts))
    flops = _extrapolate(a1, a2, mult, "flops")
    bytes_ = _extrapolate(a1, a2, mult, "bytes")
    coll: CollectiveStats = a2["coll"].scaled_diff(a1["coll"], mult)
    terms = RooflineTerms(
        flops_per_chip=flops,
        bytes_per_chip=bytes_,
        link_traffic_per_chip=coll.total_traffic,
        chips=mesh.size,
        model_flops=model_flops(cfg, shape),
    )
    return {"flops": flops, "bytes": bytes_, "coll": coll, "terms": terms,
            "pair_layers": [c1.num_layers, c2.num_layers], "mult": mult}


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             opts: ShardOptions = ShardOptions(),
             opts_tag: str = "baseline",
             cfg_overrides: Optional[Dict] = None) -> Dict:
    """One cell: the full-depth step run (memory, coherence), then the
    cost pair run and extrapolated (``pair_terms``)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    mesh = meta_mesh(multi_pod)
    t0 = time.time()

    # 1) full depth: coherence, memory, the ledger of the whole step
    full_build = _lower(cfg, shape, mesh, opts)
    full = _analyze(full_build)
    t_full = time.time() - t0
    mem, temp_run = full["mem"], full["totals"]["temp_bytes_run"]

    # 2) the cost pair at the real chunk, extrapolated to full depth
    pair = pair_terms(cfg, shape, mesh, opts)
    coll = pair["coll"]
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": mesh.size, "opts": opts_tag,
        "status": "ok",
        "compile_s": round(t_full, 1),
        "memory": mem,
        "hbm_per_device_gib": round(
            (mem["argument_bytes"] + mem["temp_bytes"]
             + mem["output_bytes"] - mem["alias_bytes"]) / 2 ** 30, 3),
        "full_module": {
            "flops_per_chip_raw": full["flops"],
            "collective_counts": full["collective_counts"],
            "collective_bytes_raw": full["coll"].bytes_by_kind,
            "bytes_per_chip_raw": full["bytes"],
            "collective_traffic_raw": full["coll"].traffic_by_kind,
        },
        "extrapolated": {
            "flops_per_chip": pair["flops"],
            "bytes_per_chip": pair["bytes"],
            "collective_bytes": coll.bytes_by_kind,
            "collective_traffic_per_chip": coll.traffic_by_kind,
        },
        "roofline": pair["terms"].to_dict(),
        "param_counts": param_counts(cfg),
        "shape_only": {
            "attribution": ATTRIBUTION,
            "temp_bytes_run": temp_run,
            "one_card_bytes": one_card_bytes(full_build, temp_run),
            "pair_layers": pair["pair_layers"], "mult": pair["mult"],
        },
    }


ATTRIBUTION = ("per chip: flops and bytes are the mesh's run / chips; "
               "temp_bytes is the origin row's live intermediates / its "
               "shards plus the rest / chips; argument, output and alias "
               "bytes and the collective ledger are the origin shard's")


def one_card_bytes(build, temp_run: float) -> float:
    """What one card holding every shard of ``build``'s mesh needs at its
    peak: every shard's parts of the arguments (each shard its own copy
    of a replicated leaf) and the run's live intermediates, one row at a
    time (``temp_bytes_run``)."""
    return float(origin_bytes(build.args, build.shardings, every_shard=True)
                 + temp_run)


def save_result(result: Dict, out_dir: str = OUT_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{result['arch']}__{result['shape']}__{result['mesh']}__{result['opts']}.json"
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Shape-only dry run of the sharded steps on a meta "
                    "production mesh (no card needed).")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--strategy", default="tp")
    ap.add_argument("--seq-parallel", type=int, default=1)
    ap.add_argument("--decode-quant", default=None)
    ap.add_argument("--moe-mode", default="ep")
    ap.add_argument("--zero1", type=int, default=0)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--ssm-chunk", type=int, default=None)
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--ssm-bf16", type=int, default=0)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname).1s %(name)s] "
                               "%(message)s", datefmt="%H:%M:%S")
    overrides = {}
    if args.ssm_chunk:
        overrides["ssm_chunk"] = args.ssm_chunk
    if args.attn_chunk:
        overrides["attn_chunk"] = args.attn_chunk
    if args.ssm_bf16:
        overrides["ssm_compute_dtype"] = "bfloat16"

    opts = ShardOptions(strategy=args.strategy,
                        seq_parallel=bool(args.seq_parallel),
                        moe_mode=args.moe_mode, zero1=bool(args.zero1),
                        decode_quant=args.decode_quant)

    cells = []
    if args.all:
        for a in ARCH_IDS:
            cfg = get_config(a)
            for s in SHAPES:
                if s in cfg.skip_shapes:
                    continue
                cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            tag_mesh = "2x16x16" if mp else "16x16"
            out_name = os.path.join(
                args.out, f"{arch}__{shape}__{tag_mesh}__{args.tag}.json")
            if args.skip_existing and os.path.exists(out_name):
                log.info("skip existing %s", out_name)
                continue
            log.info("=== %s x %s x %s ===", arch, shape, tag_mesh)
            try:
                res = run_cell(arch, shape, multi_pod=mp, opts=opts,
                               opts_tag=args.tag, cfg_overrides=overrides)
                path = save_result(res, args.out)
                rl = res["roofline"]
                log.info("ok: hbm/dev=%.2fGiB compute=%.4fs memory=%.4fs "
                         "coll=%.4fs bottleneck=%s (full run %.1fs) -> %s",
                         res["hbm_per_device_gib"], rl["compute_s"],
                         rl["memory_s"], rl["collective_s"], rl["bottleneck"],
                         res["compile_s"], path)
            except Exception as e:  # noqa: BLE001 — record and continue
                failures.append((arch, shape, tag_mesh, repr(e)))
                log.error("FAILED %s x %s x %s: %s", arch, shape, tag_mesh, e)
                traceback.print_exc()
                save_result({"arch": arch, "shape": shape, "mesh": tag_mesh,
                             "opts": args.tag, "status": "failed",
                             "error": repr(e)}, args.out)
    if failures:
        log.error("%d cells failed: %s", len(failures), failures)
        raise SystemExit(1)
    log.info("all cells passed")


if __name__ == "__main__":
    main()
