"""Counter emission: the zero-sync half of the obs subsystem (port of
``repro.obs.runtime``: the same registry, names, kinds and shapes, and
the same packed layout).

The reference adds its counters while the burst is being TRACED: a few
scalar adds inside one compiled graph. Eager PyTorch runs every
``emit`` on every executed call, so the port splits a counter's
contributions by who knows the value:

  * values the host already knows — call counts, steps, bursts, the
    burst histogram, proposed drafts, element counts — are Python
    numbers; a sink sums them on the host and ``fold`` moves them into
    the host half of the counter state (``init_host_counters``), which
    the drain adds to what it reads;
  * data-dependent values — useful tokens, accepted drafts, paged
    tokens read, saturated activations, clipped fake-quant values, MoE
    drops — are tensors; a sink keeps them as they are emitted and
    ``fold`` adds each counter's sum in place to the device buffer
    (``init_counters``: one flat int32 and one flat fp32 tensor on the
    engine's device), one add a counter a dispatch rather than one an
    emit. Nothing is read back until
    ``obs.counters.DeviceCounters.drain``.

With no sink on the stack (observability off, or a kernel called
outside any engine) ``emit`` is a Python check that returns; no stats
reduction is computed unless ``emitting_stats()`` is true (a burst on
the ``ObsConfig.stats_every`` cadence).

Tensor-parallel call sites (``ShardedDequantContext``, the
kv-head-sharded paged read) emit their statistics once from the
REPLICATED pre-shard values and run the per-shard kernel calls under
``suspended()``, so the counters are tp-invariant, as in the reference.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

# log2 burst-size histogram buckets: 2^0 .. 2^(HIST_BUCKETS-1) steps
HIST_BUCKETS = 8


@dataclasses.dataclass(frozen=True)
class CounterSpec:
    kind: str                    # "i32" (exact, parity-checked) | "f32"
    shape: Tuple[int, ...] = ()
    doc: str = ""


# The full counter registry. Every name an ``emit`` call may use is
# declared here, so the buffer has a fixed layout and unknown names fail
# at the first emit.
COUNTERS: Dict[str, CounterSpec] = {
    # -- engine-level (int32: drained values equal the host bookkeeping
    #    exactly) --
    "decode_bursts": CounterSpec("i32", (), "engine_step dispatches"),
    "decode_steps": CounterSpec("i32", (), "fused decode steps run"),
    "decode_tokens": CounterSpec(
        "i32", (), "USEFUL tokens written (burst overshoot excluded — "
        "same active & budget mask as the output scatter)"),
    "burst_size_hist": CounterSpec(
        "i32", (HIST_BUCKETS,), "log2(steps) histogram of burst sizes"),
    # -- speculative decoding (exact device-side tallies; the host keeps
    #    only a budget-clamp-lossy estimate, see Engine.spec_stats) --
    "spec_proposed": CounterSpec(
        "i32", (), "draft tokens proposed to verification (k per active "
        "slot per spec dispatch)"),
    "spec_accepted": CounterSpec(
        "i32", (), "proposed draft tokens whose verify re-sample matched "
        "(the accept-rate numerator; excludes correction/bonus tokens)"),
    # -- kernel/context taps (f32 sums; rates, not exact counts) --
    "qmm_calls": CounterSpec("f32", (), "fused qmm dispatches"),
    "int8mm_calls": CounterSpec("f32", (), "legacy int8 matmul dispatches"),
    "act_sat": CounterSpec(
        "f32", (), "row-quantized activation values at the int8 rail "
        "(|q| == 127) — the serve-time clip-rate numerator"),
    "act_elems": CounterSpec("f32", (), "row-quantized activation values"),
    "fq_clip": CounterSpec("f32", (), "fake-quant values clipped to the grid"),
    "fq_elems": CounterSpec("f32", (), "fake-quant values processed"),
    "paged_calls": CounterSpec("f32", (), "paged-attention dispatches"),
    "paged_tokens_read": CounterSpec(
        "f32", (), "KV tokens attended over across paged reads"),
    "moe_dropped_tokens": CounterSpec(
        "f32", (), "MoE token->expert assignments dropped past expert "
        "capacity (sum over layers; 0 means every routed token was "
        "served)"),
}

_DTYPES = {"i32": torch.int32, "f32": torch.float32}
_HOST_DTYPES = {"i32": np.int64, "f32": np.float64}

# module-level sink stack + suspension depth
_STACK: List["CounterSink"] = []
_SUSPEND: int = 0


def _layout() -> Dict[str, Tuple[str, int, int]]:
    """name -> (kind, offset, size) into the packed per-kind arrays."""
    out: Dict[str, Tuple[str, int, int]] = {}
    used = {"i32": 0, "f32": 0}
    for name, spec in COUNTERS.items():
        n = 1
        for d in spec.shape:
            n *= d
        out[name] = (spec.kind, used[spec.kind], n)
        used[spec.kind] += n
    return out


_LAYOUT = _layout()
_SIZES = {kind: sum(n for k, _, n in _LAYOUT.values() if k == kind)
          for kind in _DTYPES}


class CounterSink:
    """Collects the contributions of one emission region (a decode burst
    or a speculative dispatch): host numbers summed in ``sums``, tensors
    kept in ``tensors`` for ``fold``.

    ``stats=False`` builds a cheap sink: call/token counters still
    collect, but the element-wise clip statistics (``emitting_stats``
    guards) are skipped; the engine samples them on a burst cadence, so
    the clip RATES stay unbiased (numerator and denominator are sampled
    together).
    """

    def __init__(self, stats: bool = True) -> None:
        self.stats = stats
        self.sums: Dict[str, float] = {}
        self.tensors: Dict[str, List[torch.Tensor]] = {}

    def add(self, name: str, value) -> None:
        if name not in COUNTERS:
            raise KeyError(
                f"emit({name!r}): unregistered counter — declare it in "
                "repro_torch.obs.runtime.COUNTERS")
        if isinstance(value, torch.Tensor):
            self.tensors.setdefault(name, []).append(value.reshape(-1))
        else:
            self.sums[name] = self.sums.get(name, 0) + value


def emitting() -> bool:
    """True when an enclosing region is collecting counters."""
    return bool(_STACK) and not _SUSPEND


def emitting_stats() -> bool:
    """True when the collecting sink also wants the EXPENSIVE
    element-wise statistics (saturation / clip-rate reductions) — gate
    any emit whose value costs a pass over an activation tensor on
    this, not on :func:`emitting`."""
    return bool(_STACK) and not _SUSPEND and _STACK[-1].stats


def emit(name: str, value) -> None:
    """Add ``value`` to counter ``name``: a Python number (host-known,
    summed on the host) or a tensor (data-dependent, summed on its
    device). A no-op outside a ``collecting`` region or inside a
    ``suspended`` one."""
    if not _STACK or _SUSPEND:
        return
    _STACK[-1].add(name, value)


@contextmanager
def collecting(sink: CounterSink):
    """Route ``emit`` calls to ``sink`` for the duration of the block."""
    _STACK.append(sink)
    try:
        yield sink
    finally:
        _STACK.pop()


@contextmanager
def suspended():
    """Silence ``emit`` — wrap per-shard kernel calls so shard-local
    values never reach the sink twice."""
    global _SUSPEND
    _SUSPEND += 1
    try:
        yield
    finally:
        _SUSPEND -= 1


# ---------------------------------------------------------------------------
# packed buffers
#
# The device buffer is TWO flat tensors ({"i32": (Ni,), "f32": (Nf,)}),
# not one tensor a counter: a drain reads them in one device-to-host
# copy. Each counter owns a static slice of its kind's tensor (registry
# order). The host half has the same layout in numpy (int64 / float64).
# ---------------------------------------------------------------------------

def init_counters(device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A zeroed device counter buffer on ``device`` (default: the GPU)."""
    dev = resolve_device(device)
    return {kind: torch.zeros(_SIZES[kind], dtype=dtype, device=dev)
            for kind, dtype in _DTYPES.items()}


def init_host_counters() -> Dict[str, np.ndarray]:
    """A zeroed host half (the sums of host-known contributions)."""
    return {kind: np.zeros(_SIZES[kind], dtype)
            for kind, dtype in _HOST_DTYPES.items()}


def ctr_get(ctr, name: str):
    """Counter ``name``'s view of a packed buffer (registry shape)."""
    kind, off, n = _LAYOUT[name]
    return ctr[kind][off:off + n].reshape(COUNTERS[name].shape)


def ctr_add(ctr, name: str, value, idx: int = 0):
    """Add ``value`` to counter ``name`` (element ``idx`` for vector
    counters, e.g. a histogram bucket), in place: on a host buffer a
    numpy add, on a device buffer one in-place slice add (a tensor
    value stays on the device; nothing is read back). Returns ``ctr``."""
    kind, off, n = _LAYOUT[name]
    if not 0 <= idx < n:
        raise IndexError(f"{name}: element {idx} of {n}")
    buf = ctr[kind]
    if isinstance(buf, np.ndarray):
        buf[off + idx] += value
        return ctr
    if (isinstance(value, torch.Tensor) and kind == "i32"
            and value.is_floating_point()):
        value = value.to(buf.dtype)
    buf.narrow(0, off + idx, 1).add_(value)
    return ctr


def unpack_counters(host: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Split a drained (host-side) packed buffer into per-name arrays."""
    if not host:
        return {}
    return {name: np.asarray(host[kind][off:off + n]).reshape(
                COUNTERS[name].shape)
            for name, (kind, off, n) in _LAYOUT.items()}


def fold(ctr, sink: CounterSink, host):
    """Add a sink's contributions into the counter state, in place, and
    empty it: its host numbers into the host half ``host``, each
    counter's tensors summed into the device buffer ``ctr`` (nothing is
    read back). Returns ``ctr``."""
    for name, v in sink.sums.items():
        ctr_add(host, name, v)
    for name, vs in sink.tensors.items():
        ctr_add(ctr, name, torch.sum(vs[0] if len(vs) == 1 else torch.cat(vs)))
    sink.sums.clear()
    sink.tensors.clear()
    return ctr
