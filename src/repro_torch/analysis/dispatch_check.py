"""Dispatch-level numerics and zero-sync checker (the RPR1xx rules; the
port's counterpart of the reference's traced-graph checker).

The port has no traced graph, so each target runs eagerly under a
``TorchDispatchMode`` that sees every aten op with its dtypes and
devices (``OpRecorder``); ``TPMesh.psum`` and ``TPMesh.all_gather`` are
wrapped for the duration, so the checker sees the collectives'
operands. The targets are the serving units: the kernel wrappers
(``qmm``, ``int8_matmul``, ``paged_attention``) and, for every storage
mode of the engine, its admission (prefill, not hot) and the device work
of one burst (``Engine._engine_step``; ``Engine._spec_step`` under
speculative decoding), over smoke configs on ``device``:

  RPR101  no float64 tensor anywhere
  RPR102  no int32 -> fp16/bf16 conversion (``_to_copy`` / ``copy_``):
          an int32 accumulator may only widen to fp32 before the fold
  RPR103  in hot targets, nothing that synchronizes the host with the
          device: ``_local_scalar_dense`` (``.item()``, ``int()``,
          ``bool()``), ``nonzero``, ``is_nonzero``, ``masked_select``,
          ``_unique2``, ``unique_dim``, boolean-mask indexing,
          ``repeat_interleave`` with tensor repeats and no
          ``output_size``, a copy across devices, and a tensor made from
          host data (``lift_fresh``: on the card a pageable host-to-device
          copy). On CUDA every call ``torch.cuda.set_sync_debug_mode
          ("warn")`` reports counts too, by source line: that count is
          the authority on the card (the CPU's dispatcher cannot see
          ``.cpu()`` of a CPU tensor). The CUDA kernels are called
          through ``ctypes``, so no dispatch mode sees them; their
          wrappers' aten ops and their syncs are seen.
  RPR104  ``TPMesh.psum`` over a floating operand in an engine target
          (integer sums are exact; the port's row-parallel combine folds
          fp32 terms through ``qmm_groups_fold``, not through psum)

``sync_calls`` is the sync-debug counter on its own, by the innermost
source line outside torch (``chip_smoke.py`` phases 3i and 3l read it).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import linecache
import os
import sys
import warnings
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding

# aten ops that read a device value on the host (or size an output by
# one) and so block until the device is done
_SYNC_OPS = {"_local_scalar_dense", "nonzero", "is_nonzero", "masked_select",
             "_unique2", "unique_dim"}
_LOSSY_FROM_INT32 = (torch.float16, torch.bfloat16)
# rpr-ok: RPR003 the dtype RPR101 looks for; the checker makes no double
_F64 = torch.float64
_TORCH_DIR = os.path.dirname(torch.__file__)
_THIS_FILE = os.path.abspath(__file__)


@dataclasses.dataclass
class OpRecord:
    """One dispatched aten op (or a wrapped collective) that a rule reads."""

    name: str
    in_dtypes: Tuple[torch.dtype, ...]
    out_dtypes: Tuple[torch.dtype, ...]
    sync: Optional[str] = None       # why this op synchronizes, or None
    site: Optional[str] = None       # the calling source line


def _tensors(*trees) -> List[torch.Tensor]:
    """The tensors among ``trees`` (args, kwarg values, outputs), one
    level of lists and tuples deep — the shapes aten signatures take."""
    out: List[torch.Tensor] = []
    for tree in trees:
        for a in (tree if isinstance(tree, (list, tuple)) else (tree,)):
            if isinstance(a, torch.Tensor):
                out.append(a)
            elif isinstance(a, (list, tuple)):
                out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def caller_site() -> str:
    """``dir/file.py:line code`` of the innermost frame outside torch, the
    warnings machinery and this module: the line of the package (or of
    the script) that made the call."""
    fr = sys._getframe(1)
    while fr is not None:
        fn = fr.f_code.co_filename
        if not (fn == _THIS_FILE or fn.startswith(_TORCH_DIR)
                or os.path.basename(fn) in ("warnings.py", "contextlib.py")):
            code = linecache.getline(fn, fr.f_lineno).strip()
            parent = os.path.basename(os.path.dirname(fn))
            return f"{parent}/{os.path.basename(fn)}:{fr.f_lineno} {code}"
        fr = fr.f_back
    return "?"


def _sync_reason(name: str, args, kwargs, ins, outs) -> Optional[str]:
    if name in _SYNC_OPS:
        return name
    if name == "lift_fresh":
        return "tensor made from host data (a pageable upload on the card)"
    if name == "repeat_interleave":
        tensor_repeats = (
            isinstance(args[0], torch.Tensor) if len(args) == 1
            else len(args) > 1 and isinstance(args[1], torch.Tensor))
        if tensor_repeats and kwargs.get("output_size") is None:
            return "repeat_interleave without output_size"
    if name in ("index", "index_put", "index_put_") and len(args) > 1:
        idx = args[1] or ()
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.bool
               for t in idx):
            return f"{name} with a boolean mask (nonzero)"
    if name in ("_to_copy", "copy_", "_copy_from"):
        devs = {t.device for t in ins} | {t.device for t in outs}
        if "device" in kwargs and kwargs["device"] is not None:
            devs.add(torch.device(kwargs["device"]))
        if len({d.type for d in devs}) > 1:
            return "copy across devices " + " -> ".join(
                sorted({str(d) for d in devs}))
    return None


# ops whose dtypes RPR102 reads (every op is counted; these are kept)
_KEPT = {"_to_copy", "copy_"}


class OpRecorder(TorchDispatchMode):
    """Sees every aten op dispatched while it is active and keeps those the
    rules read: float64 ones, dtype conversions, synchronizing ones, with
    their source line. On a CUDA target the sync-debug warnings raised
    inside an op are attributed to that op (``current``)."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.n_ops = 0
        self.current: Optional[str] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        prev, self.current = self.current, name
        try:
            out = func(*args, **kwargs)
        finally:
            self.current = prev
        self.n_ops += 1
        ins, outs = _tensors(args, tuple(kwargs.values())), _tensors(out)
        sync = _sync_reason(name, args, kwargs, ins, outs)
        if sync or name in _KEPT or any(
                t.dtype == _F64 for t in ins + outs):
            self.ops.append(OpRecord(
                name, tuple(t.dtype for t in ins),
                tuple(t.dtype for t in outs), sync, caller_site()))
        return out

    def note(self, name: str, parts) -> None:
        """A wrapped collective: its operands."""
        ts = _tensors(parts)
        self.ops.append(OpRecord(name, tuple(t.dtype for t in ts), (),
                                 site=caller_site()))


@contextlib.contextmanager
def _wrapped_collectives(rec: OpRecorder):
    """``TPMesh.psum`` / ``all_gather`` noted with their operands."""
    from repro_torch.launch.mesh import TPMesh
    orig_sum, orig_gather = TPMesh.psum, TPMesh.all_gather

    def psum_noted(self, parts):
        rec.note("TPMesh.psum", list(parts))
        return orig_sum(self, parts)

    def gather_noted(self, parts, dim):
        rec.note("TPMesh.all_gather", list(parts))
        return orig_gather(self, parts, dim)

    TPMesh.psum, TPMesh.all_gather = psum_noted, gather_noted
    try:
        yield
    finally:
        TPMesh.psum, TPMesh.all_gather = orig_sum, orig_gather


def _bucket(buckets: Optional[Mapping[str, str]]) -> Optional[str]:
    """The label of the innermost calling function named in ``buckets``
    (``"other"`` when none is on the stack)."""
    if not buckets:
        return None
    fr = sys._getframe(1)
    while fr is not None:
        label = buckets.get(fr.f_code.co_name)
        if label is not None:
            return label
        fr = fr.f_back
    return "other"


@contextlib.contextmanager
def _sync_events(on: bool, rec: Optional[OpRecorder] = None,
                 buckets: Optional[Mapping[str, str]] = None):
    """Collect ``(site, op, bucket)`` for every synchronizing CUDA call
    that ``torch.cuda.set_sync_debug_mode("warn")`` reports inside the
    block (nothing when ``on`` is false). The warning is attributed where
    it is raised, so the site is the calling line, not the op's
    internals."""
    events: List[Tuple[str, Optional[str], Optional[str]]] = []
    if not on:
        yield events
        return
    armed = [False]

    def hook(message, category, filename, lineno, file=None, line=None):
        # the mode's own switch may warn once a process: not the block's
        if armed[0] and "synchroniz" in str(message):
            events.append((caller_site(), rec.current if rec else None,
                           _bucket(buckets)))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        armed[0] = True
        try:
            yield events
        finally:
            armed[0] = False
            torch.cuda.set_sync_debug_mode("default")


def sync_calls(fn: Callable[[], object],
               buckets: Optional[Mapping[str, str]] = None
               ) -> Tuple[int, Dict[str, int], Dict[str, int]]:
    """``fn()`` under ``set_sync_debug_mode("warn")`` on the card: the
    number of synchronizing CUDA calls it made, their count by the
    innermost source line outside torch, and by ``buckets`` (function
    name -> label: each call counts under the innermost such function on
    its stack, else under ``"other"``)."""
    with _sync_events(True, buckets=buckets) as events:
        fn()
    return (len(events), dict(collections.Counter(e[0] for e in events)),
            dict(collections.Counter(e[2] for e in events)))


def check_ops(ops: List[OpRecord], target: str, hot: bool = False,
              engine: bool = False,
              syncs: Optional[List[Tuple]] = None) -> List[Finding]:
    """The RPR1xx findings of one target's recorded ops (and, on the
    card, its sync-debug events)."""
    findings: List[Finding] = []
    for op in ops:
        if any(d == _F64 for d in op.in_dtypes + op.out_dtypes):
            findings.append(Finding(
                "RPR101", "error", target,
                f"float64 tensor in `{op.name}` at {op.site} — doubles are "
                "outside every exactness contract"))
            break
    for op in ops:
        if op.name in ("_to_copy", "copy_") and op.in_dtypes:
            src = op.in_dtypes[-1] if op.name == "copy_" else op.in_dtypes[0]
            dst = op.out_dtypes[0] if op.out_dtypes else op.in_dtypes[0]
            if src == torch.int32 and dst in _LOSSY_FROM_INT32:
                findings.append(Finding(
                    "RPR102", "error", target,
                    f"lossy cast int32 -> {str(dst).split('.')[-1]} at "
                    f"{op.site}: a group/K accumulator truncated before the "
                    "scale fold (int32 must widen to fp32; fold first, "
                    "downcast after)"))
        if engine and op.name == "TPMesh.psum":
            bad = [d for d in op.in_dtypes if d.is_floating_point]
            if bad:
                findings.append(Finding(
                    "RPR104", "error", target,
                    f"TPMesh.psum over a {str(bad[0]).split('.')[-1]} "
                    f"operand at {op.site}: float adds across shards depend "
                    "on their order; sum int32, or fold fp32 terms in order "
                    "(qmm_groups_fold)"))
    if hot:
        by_site: Dict[str, List] = collections.defaultdict(lambda: [set(), 0])
        for op in ops:
            if op.sync:
                by_site[op.site][0].add(op.sync)
        for site, op_name, _ in syncs or ():
            by_site[site][1] += 1
            if op_name:
                by_site[site][0].add(op_name)
        for site, (why, n) in sorted(by_site.items()):
            counted = (f"{n} synchronizing CUDA call(s)" if n
                       else "a synchronizing op")
            findings.append(Finding(
                "RPR103", "error", target,
                f"{counted} in the decode hot path at {site} "
                f"({', '.join(sorted(why)) or 'sync debug mode'}) — every "
                "step would wait for the device"))
    return findings


def record(fn: Callable[[], object], device: torch.device
           ) -> Tuple[OpRecorder, List[Tuple]]:
    """Run ``fn()`` under the recorder (and, on CUDA, the sync-debug
    counter); returns the recorder and the sync events."""
    rec = OpRecorder()
    on_card = torch.device(device).type == "cuda"
    with torch.no_grad(), _wrapped_collectives(rec), \
            _sync_events(on_card, rec) as events, rec:
        fn()
    return rec, events


# ---------------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Target:
    name: str
    call: Callable[[], object]   # the work the recorder sees
    hot: bool = False            # held to the decode hot-path rules


def _kernel_targets(device: torch.device) -> Iterator[Target]:
    from repro_torch.kernels import ops
    from repro_torch.qtensor import quantize

    x_q = torch.zeros((8, 32), dtype=torch.int8, device=device)
    xs = torch.ones((8, 1), dtype=torch.float32, device=device)
    w = quantize(torch.ones((32, 16), device=device), 4, group_size=8)
    yield Target("kernels.ops.qmm[W4A8,g=8]",
                 lambda: ops.qmm(x_q, w, xs), hot=True)
    w_q = torch.zeros((32, 16), dtype=torch.int8, device=device)
    ws = torch.ones((16,), dtype=torch.float32, device=device)
    yield Target("kernels.ops.int8_matmul[W8A8]",
                 lambda: ops.int8_matmul(x_q, w_q, xs, ws), hot=True)
    q = torch.zeros((2, 1, 4, 16), dtype=torch.float32, device=device)
    kp = torch.zeros((6, 4, 2, 16), dtype=torch.float32, device=device)
    table = torch.zeros((2, 3), dtype=torch.int32, device=device)
    pos = torch.zeros((2,), dtype=torch.int32, device=device)
    yield Target("kernels.ops.paged_attention[fp]",
                 lambda: ops.paged_attention(q, kp, kp, table, pos), hot=True)


ENGINE_VARIANTS = ("dense", "qtensor", "int8", "paged", "obs", "perf",
                   "moe-grouped", "moe-dense", "spec", "spec-paged", "sharded",
                   "moe-ep")


def smoke_engine(variant: str, device: torch.device):
    """A smoke-scale Engine in one of the serving storage modes (the
    reference checker's settings)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import TPMesh
    from repro_torch.models.transformer import init_params
    from repro_torch.obs import ObsConfig
    from repro_torch.serve import (
        Engine, EngineConfig, SpecConfig, quantize_params,
        quantize_params_int8)

    moe = variant.startswith("moe")
    spec = variant.startswith("spec")
    cfg = smoke_config("deepseek_moe_16b" if moe else "internlm2_1_8b")
    ecfg = dict(max_slots=2, max_len=32, max_new_tokens=8,
                prefill_chunk=8, decode_burst=4)
    params = init_params(cfg, seed=0, device=device)
    scales = None
    if variant in ("qtensor", "paged", "sharded", "obs", "perf") \
            or moe or spec:
        params, scales = quantize_params(params, 4, group_size=8,
                                         device=device)
        ecfg["int8_compute"] = True
    elif variant == "int8":
        params, scales = quantize_params_int8(params, 8, device=device)
        ecfg["int8_compute"] = True
    if variant in ("paged", "sharded", "obs", "perf", "spec-paged"):
        ecfg.update(kv_cache="paged", page_size=8)
    if spec:
        # the W4 serving tree narrowed to a W3 draft over a low-bit KV
        # lane (int8 dense / packed int4 paged)
        ecfg["spec"] = SpecConfig(
            k=3, draft_bits=3,
            draft_kv_bits=4 if variant == "spec-paged" else 8)
    if variant == "moe-dense":
        ecfg["moe_dispatch"] = "dense"
    if variant in ("sharded", "moe-ep"):
        # two shards of a single-controller mesh on one device; for the
        # MoE model its expert stacks shard by expert (the "ep" route)
        ecfg["mesh"] = TPMesh([device] * 2)
    if variant == "obs":
        ecfg["obs"] = ObsConfig(device_metrics=True)
    if variant == "perf":
        ecfg["obs"] = ObsConfig(trace=True, device_metrics=True, perf=True,
                                time_every=1)
    return Engine(params, cfg, EngineConfig(**ecfg), scales=scales,
                  device=None if "mesh" in ecfg else device)


def smoke_requests(cfg, n: int = 2):
    """Prompts of 5 and 9 tokens (one partial prefill chunk, one full and
    a partial one), 8 new tokens, greedy."""
    import numpy as np

    from repro_torch.serve import Request
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(0, cfg.vocab_size, size=(5 + 4 * i,),
                                    dtype=np.int32), 8)
            for i in range(n)]


def _engine_targets(variant: str, device: torch.device) -> Iterator[Target]:
    """The admission of two requests (not hot; the second one's prefill
    interleaves a burst), then the device work of one burst (hot): two
    decode steps, or one draft/verify dispatch. Where counters are on,
    the burst's sink takes the clip statistics too (the heaviest burst
    the cadence dispatches)."""
    from repro_torch.obs import runtime as obs_rt

    eng = smoke_engine(variant, device)
    eng._start_run()
    reqs = smoke_requests(eng.cfg)
    yield Target(f"engine[{variant}].prefill",
                 lambda: [eng._admit(r) for r in reqs], hot=False)
    sink = obs_rt.CounterSink(stats=True) if eng._ctr else None
    if eng._spec is not None:
        if eng._paged:
            eng._grow_tables(eng._spec.k + 1)
        yield Target(f"engine[{variant}].spec_step",
                     lambda: eng._spec_step("greedy", sink, len(reqs)),
                     hot=True)
    else:
        if eng._paged:
            eng._grow_tables(2)
        yield Target(f"engine[{variant}].engine_step",
                     lambda: eng._engine_step(2, "greedy", sink), hot=True)


def collect_notes() -> List[Finding]:
    """Targets the port cannot run, reported, never skipped silently:
    none since the expert-parallel target (``engine[moe-ep]``) runs."""
    return []


def run(device=None, variants=ENGINE_VARIANTS,
        stats: Optional[Dict[str, Dict]] = None) -> List[Finding]:
    """Run every target on ``device`` (default: the GPU) and check it;
    ``stats`` (a dict) receives each target's op count and, on the card,
    its synchronizing calls."""
    from repro_torch._device import resolve_device

    dev = resolve_device(device)
    findings = collect_notes()
    groups = [("kernels.ops", lambda: _kernel_targets(dev))] + [
        (f"engine[{v}]", lambda v=v: _engine_targets(v, dev))
        for v in variants]
    for group, make in groups:
        try:
            for t in make():
                try:
                    rec, syncs = record(t.call, dev)
                except Exception as e:  # noqa: BLE001 - surface as a finding
                    findings.append(Finding(
                        "RPR100", "error", t.name,
                        f"target failed: {type(e).__name__}: {e}"))
                    continue
                if stats is not None:
                    stats[t.name] = {"hot": t.hot, "ops": rec.n_ops,
                                     "syncs": len(syncs)}
                findings.extend(check_ops(
                    rec.ops, t.name, hot=t.hot,
                    engine=t.name.startswith("engine["), syncs=syncs))
        except Exception as e:  # noqa: BLE001 - surface as a finding
            findings.append(Finding(
                "RPR100", "error", group,
                f"target setup failed: {type(e).__name__}: {e}"))
    return findings
