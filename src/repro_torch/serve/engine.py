"""Continuous-batching inference engine (port of ``repro.serve.engine``).

    loadgen ──> arrival queue ──> admission ──> slots [0..S) ──> finished
                                   │                 ▲
                                   │ chunked prefill │ eviction on
                                   ▼ (batch-1 loop)  │ EOS / budget,
                                 insert into slot ───┘ immediate backfill

A request is prefilled alone (batch 1) in chunks into a dense scratch
state, then inserted into its slot: copied into the dense batched cache,
or scattered into freshly allocated pages (``kv_cache="paged"``). With
prefix sharing (paged, the default) admission first matches the prompt
against resident pages: matched full pages are shared by reference, the
scratch state is seeded from them and only the suffix is prefilled; a
partially matched boundary page is copied (copy-on-write) before the
suffix is written into it. Decode bursts run ``decode_step`` over all
slots; inactive slots ride along with frozen positions (writes past a
slot's limit or past the dense cache are dropped).
Every batch row is computed independently — per-row activation scales
on the ``qmm`` route, per-row cache writes and masks — so a request's
tokens equal those of the same request served alone.

Ported: greedy and sampled decoding (per-request seeded temperature /
top-k / top-p, ``serve.sampling``: the reference's keys, so a sampled
stream equals the reference engine's), self-speculative decoding
(``EngineConfig(spec=SpecConfig(...))``, ``serve.spec``), dense and
paged KV, prefix sharing and copy-on-write, chunked prefill interleaved
with decode, page-table growth, eviction and backfill, admission
deferral when the page pool is full; packed QTensor and int8-backed
(path-keyed ``scales``) weights; every family: dense, MoE, ssm, hybrid,
audio and vlm (MoE expert stacks through ``grouped_qmm``, or the
per-expert ``qmm`` loop or the fp einsum, by ``moe_dispatch``). On the
MoE path the row independence above stops at the experts' capacity,
which couples a token to its batch-mates as it does in the reference.

The recurrent families (ssm, hybrid) carry an SSM state a slot beside
(hybrid) or instead of (ssm) the KV cache: admission overwrites the
slot's whole state with the prefilled one, on the dense and the paged
route; inactive slots ride along with frozen positions (their state
advances harmlessly until the next admission overwrites it); under a
mesh the states stay on the lead device. The ssm family holds no KV to
page; the hybrid serves without prefix sharing (a shared prefix would
also need the SSM state at the split point, which is not cached); and
neither takes speculative decoding (a recurrent state cannot rewind
rejected drafts), as in the reference.

The audio family serves (P, CB) codebook grids: the slots' tokens are
(S, 1, CB), a request's output (G, CB), each codebook sampled under the
token's one key, and a speculative draft matches only where every
codebook does; a prompt shares a prefix with another only where every
codebook agrees. The vlm family serves text prompts, as the reference's
requests carry no image.

Sampled bursts specialize the sampler to what the active requests need
(``_mode_for``: ``greedy``, ``nofilter`` or ``full``); a row samples the
same tokens in every mode that serves it. The first token of a request
is sampled at admission with the key of token index 0, token ``t`` of a
burst with the key of ``t``.

Speculative decoding replaces every decode burst with one draft/verify
dispatch (``_spec_burst``): a draft lane — the serving tree, or one
narrowed to FIT-chosen widths and materialized to fp once, over its own
KV (dense int8/fp, or paged pools at ``draft_kv_bits`` driven by the
live serving page table, so sharing, copy-on-write and recycling carry
over) — proposes k tokens; one (k+1)-token verify of the serving config
re-samples every column with the plain engine's keys; the longest
matching prefix plus one token is emitted, and both lanes roll back by
position. The emitted streams are the plain engine's, bit for bit.

Tensor-parallel serving (``EngineConfig(mesh=make_tp_mesh(N))``, a
``launch.mesh.TPMesh``): one process drives every shard, as the
reference's single controller does. ``serve.quantized.shard_params``
splits the quantized blocks column-, row- or expert-wise across the
mesh's devices, ``ShardedDequantContext`` runs them shard by shard, and
(paged, when the kv heads divide the mesh) the page pools shard by kv
head; the scheduler, slot tables, token buffers and the dense scratch
state stay on the lead device. Every combine is an integer sum or a
concatenation in order, so an engine at any tp emits the tp=1 tokens.

Observability (``EngineConfig(obs=ObsConfig(...))``, ``repro_torch.obs``;
everything off by default): a Chrome-trace span per request (admit,
prefill chunks, evict) and per batch-wide dispatch (decode or spec
bursts, drains) with a jsonl event log (``tracer``); counters whose
host-known parts are summed on the host and whose data-dependent parts
(useful tokens from the device slot table, accepted drafts, paged
tokens read, clip statistics on every ``stats_every``-th burst) are
added in place on the device, drained in one copy every ``drain_every``
bursts and at run end (``counters``) — a burst adds no host read of its
own; dispatch walls with CUDA-event device time (``perf``); and a FIT
drift monitor's cadenced probe after the bursts (``attach_drift``).

Not yet ported (raises ``NotImplementedError``): speculative decoding
under a mesh (refused by the reference too).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import math
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.kvcache.allocator import BlockAllocator
from repro_torch.launch.mesh import TPMesh
from repro_torch.kvcache.paged import (
    PagedKVConfig, copy_page, gather_layer, kv_layer_count,
    page_bytes_all_layers, scatter_span)
from repro_torch.models.attention import KVCache
from repro_torch.models.context import (
    Context, DequantContext, ShardedDequantContext)
from repro_torch.models.decode import (
    DecodeState, decode_step, init_decode_state, init_paged_decode_state,
    insert_ssm_slot, prefill_into, state_insert_slot)
from repro_torch.models.transformer import require_known_family
from repro_torch.obs import DeviceCounters, ObsConfig, Tracer, init_counters
from repro_torch.obs import runtime as obs_rt
from repro_torch.obs.perf.timing import DeviceSpan, DispatchTimer
from repro_torch.obs.trace import ENGINE_TID
from repro_torch.qtensor import QTensor, tree_has_qtensor
from repro_torch.serve.metrics import EngineMetrics
from repro_torch.serve.quantized import make_dequant_context, shard_params
from repro_torch.serve.request import Request, RequestStatus
from repro_torch.serve.sampling import (
    greedy_tokens, request_keys, sample_tokens)
from repro_torch.serve.spec import (
    SpecConfig, accept_drafts, derive_draft_params, quantize_dense_kv)
from repro_torch.utils.pytree import map_with_names

log = logging.getLogger("repro_torch.serve.engine")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine shape: slot count, KV capacity, scheduling grain."""

    max_slots: int = 4
    max_len: int = 256            # per-slot KV / position capacity
    max_new_tokens: int = 128     # output-buffer width
    prefill_chunk: int = 32       # prompt tokens per prefill call
    decode_burst: int = 16        # decode steps per burst
    interleave_steps: int = 4     # decode steps run between prefill chunks
    clock: str = "steps"          # "steps" (deterministic) | "wall" (seconds)
    int8_compute: bool = False    # quantized blocks through ops.qmm / int8_matmul
    # packed MoE expert stacks (int8_compute only): "grouped" (one
    # grouped_qmm per projection), "dense" (per-expert qmm loop, the
    # bit-identity oracle) or "einsum" (fp-dequant batched einsum)
    moe_dispatch: str = "grouped"
    # ---- paged KV cache ----
    kv_cache: str = "dense"       # "dense" | "paged"
    page_size: int = 16
    kv_pages: Optional[int] = None
    prefix_sharing: bool = True   # paged: share prompt prefixes (COW)
    # ---- tensor-parallel serving: a launch.mesh.TPMesh ----
    mesh: Optional[object] = None
    # ---- self-speculative decoding (serve.spec): k > 1 replaces every
    # decode burst with a draft/verify dispatch; the emitted tokens stay
    # those of spec=None serving, bit for bit ----
    spec: Optional[SpecConfig] = None
    # ---- observability (repro_torch.obs; everything defaults OFF):
    # spans and an event log, device counters drained on a cadence,
    # timed dispatches ----
    obs: Optional[ObsConfig] = None


def _check_supported(cfg: ModelConfig, ecfg: EngineConfig) -> None:
    if ecfg.obs is not None and not isinstance(ecfg.obs, ObsConfig):
        raise TypeError(f"EngineConfig.obs must be an obs.ObsConfig "
                        f"(got {type(ecfg.obs).__name__})")
    if ecfg.spec is not None and not isinstance(ecfg.spec, SpecConfig):
        raise TypeError(f"EngineConfig.spec must be a serve.spec.SpecConfig "
                        f"(got {type(ecfg.spec).__name__})")
    if ecfg.mesh is not None and not isinstance(ecfg.mesh, TPMesh):
        raise ValueError(
            f"EngineConfig.mesh must be a TPMesh (got {type(ecfg.mesh).__name__})"
            " — build it with repro_torch.launch.mesh.make_tp_mesh")
    require_known_family(cfg)
    if ecfg.kv_cache not in ("dense", "paged"):
        raise ValueError(f"kv_cache must be dense|paged, got {ecfg.kv_cache!r}")
    if ecfg.kv_cache == "paged" and cfg.family == "ssm":
        raise ValueError("ssm family holds no KV cache to page")
    if (ecfg.spec is not None and ecfg.spec.enabled
            and cfg.family in ("ssm", "hybrid")):
        raise ValueError(
            "speculative decoding needs a rollback-able cache: the "
            f"{cfg.family} family's recurrent state cannot rewind rejected "
            "draft tokens")
    if ecfg.clock not in ("steps", "wall"):
        raise ValueError(f"clock must be steps|wall, got {ecfg.clock!r}")


class Engine:
    """Slot-based continuous-batching engine over ``decode_step``."""

    def __init__(self, params, cfg: ModelConfig, ecfg: EngineConfig,
                 scales=None, kv_bits=None,
                 kv_ranges: Optional[Mapping] = None,
                 device: DeviceLike = None):
        """``scales``: the path-keyed scales of int8-backed weights
        (``quantize_params_int8``). ``kv_bits`` (paged): None/int uniform
        or {layer -> bits} from ``kvcache.fit.allocate_kv_bits``;
        ``kv_ranges``: calibrated activation ranges for the per-page
        scales. ``device`` defaults to the GPU; with ``ecfg.mesh`` the
        engine runs on the mesh's lead device."""
        _check_supported(cfg, ecfg)
        mesh = ecfg.mesh
        self.device = resolve_device(device if mesh is None else mesh.lead)
        if (mesh is not None and device is not None
                and torch.device(device) != mesh.lead):
            raise ValueError(f"device {device} is not the mesh's lead device "
                             f"{mesh.lead}")
        self.cfg = cfg
        self.ecfg = ecfg
        quantized = tree_has_qtensor(params) or bool(scales)
        self._shard_plan: Dict[str, str] = {}
        self._kv_shards = 1
        if mesh is None:
            self.params = map_with_names(lambda _, leaf: leaf.to(self.device),
                                         params)
            self.scales = {k: v.to(self.device)
                           for k, v in (scales or {}).items()}
            self._ctx = (make_dequant_context(cfg, self.scales,
                                              int8_compute=ecfg.int8_compute,
                                              moe_dispatch=ecfg.moe_dispatch)
                         if quantized else Context())
        else:
            if quantized and not ecfg.int8_compute:
                raise ValueError(
                    "tensor-parallel serving of quantized weights needs "
                    "int8_compute=True: only the integer kernel route has "
                    "an exact (bit-identical) cross-shard reduction — the "
                    "fp-dequant path would psum floats")
            trees, shard_scales, self._shard_plan = shard_params(
                params, mesh, scales)
            self.params, self.scales = trees[0], shard_scales[0]
            self._ctx = ShardedDequantContext(
                trees, shard_scales, cfg.param_dtype, mesh, self._shard_plan,
                int8_compute=ecfg.int8_compute,
                moe_dispatch=ecfg.moe_dispatch)
            # pools shard by kv head when the heads divide the mesh;
            # otherwise they stay replicated (the tokens are the same)
            if (ecfg.kv_cache == "paged" and mesh.size > 1
                    and cfg.num_kv_heads % mesh.size == 0):
                self._kv_shards = mesh.size
            if ecfg.kv_cache == "paged":
                log.info("paged KV pools: %s across tp=%d",
                         f"sharded /{self._kv_shards} by kv-head"
                         if self._kv_shards > 1 else "replicated", mesh.size)
        self._tp = mesh.size if mesh is not None else 1
        self._paged = ecfg.kv_cache == "paged"
        self._pcfg: Optional[PagedKVConfig] = None
        self._kv_ranges = dict(kv_ranges) if kv_ranges else None
        if self._paged:
            self._pcfg = PagedKVConfig.build(
                cfg, ecfg.max_len, ecfg.max_slots, page_size=ecfg.page_size,
                num_pages=ecfg.kv_pages, kv_bits=kv_bits)
            self._n_kv_layers = kv_layer_count(cfg)
            if ecfg.prefix_sharing and cfg.family == "hybrid":
                # a shared prefix would also need the SSM state at the
                # split point, which is not cached: attention pages stay
                # paged, prefix reuse is off
                log.info("hybrid family: prefix sharing disabled "
                         "(SSM state at the split is not cached)")
        self._share = ecfg.prefix_sharing and cfg.family != "hybrid"
        # a slot's token: () or the audio family's (CB,) codebooks
        self._cb = (cfg.num_codebooks,) if cfg.family == "audio" else ()
        # ---- observability (all off by default; see repro_torch.obs) ----
        obs = ecfg.obs
        self._obs: Optional[ObsConfig] = obs
        self._obs_counters = bool(obs and obs.device_metrics)
        self.tracer = Tracer(enabled=bool(obs and obs.trace))
        self.perf: Optional[DispatchTimer] = (
            DispatchTimer(obs.time_every) if obs and obs.perf else None)
        self.counters = DeviceCounters()
        self._drift = None              # an obs.drift.DriftMonitor
        self._runnable = 0
        self._init_spec()

    def _init_spec(self) -> None:
        """The draft lane of speculative decoding: its weight tree, its
        context and (paged) its pool geometry. Refused under a mesh, as
        the reference refuses it."""
        cfg, ecfg, spec = self.cfg, self.ecfg, self.ecfg.spec
        self._spec = spec if (spec is not None and spec.enabled) else None
        if spec is not None and self._spec is None:
            log.info("spec.k=%d: running the plain burst scheduler "
                     "(speculation needs k > 1)", spec.k)
        self._draft_params = None
        self._dctx: Context = Context()
        self._dpcfg: Optional[PagedKVConfig] = None
        self.spec_stats = {"proposed": 0, "accepted": 0, "dispatches": 0}
        if self._spec is None:
            return
        spec = self._spec
        if ecfg.mesh is not None:
            raise NotImplementedError(
                "speculative decoding under tensor-parallel serving is not "
                "wired up yet (the draft lane needs its own shard plan)")
        if spec.draft_bits is not None:
            if not tree_has_qtensor(self.params):
                raise ValueError(
                    "spec.draft_bits re-packs QTensor weight storage — build "
                    "params with serve.quantized.quantize_params")
            draft = derive_draft_params(self.params, spec.draft_bits)
        else:
            draft = self.params           # low-bit-KV-only draft
        plain = False
        if (spec.materialize_draft and not spec.int8_compute
                and tree_has_qtensor(draft)):
            # dequantize once: the draft pays the fp matmul per step, and
            # its values (the FIT accept-rate trade) are unchanged
            draft = map_with_names(
                lambda _, leaf: (leaf.dequantize(cfg.param_dtype)
                                 if isinstance(leaf, QTensor) else leaf),
                draft)
            plain = True
        self._draft_params = draft
        if not plain and (self.scales or tree_has_qtensor(draft)):
            self._dctx = DequantContext(
                self.scales, cfg.param_dtype, int8_compute=spec.int8_compute,
                moe_dispatch=(ecfg.moe_dispatch if spec.int8_compute
                              else "einsum"))
        if self._paged:
            self._dpcfg = PagedKVConfig.build(
                cfg, ecfg.max_len, ecfg.max_slots, page_size=ecfg.page_size,
                num_pages=ecfg.kv_pages, kv_bits=spec.draft_kv_bits)
        elif spec.draft_kv_bits not in (8, 16):
            raise ValueError(
                "dense serving's draft KV lane supports 8 (static-scale "
                f"int8) or 16 bits, got {spec.draft_kv_bits}; packed "
                "sub-byte widths need kv_cache='paged'")

    def _fresh_counters(self) -> Dict[str, torch.Tensor]:
        """The device counter buffer on the engine's device when device
        metrics are on, ``{}`` when off."""
        if not self._obs_counters:
            return {}
        return init_counters(self.device)

    def attach_drift(self, monitor) -> None:
        """Register an ``obs.drift.DriftMonitor``: its cadenced probe runs
        after decode bursts, never inside one."""
        self._drift = monitor

    def _sink(self):
        """The counter sink of one dispatch (None with counters off); every
        ``stats_every``-th dispatch also computes the element-wise clip
        statistics."""
        if not self._ctr:
            return None
        return obs_rt.CounterSink(
            stats=self._burst_i % self._obs.stats_every == 0)

    def _decode(self, sink, params, state, toks, ctx):
        if sink is None:
            return decode_step(params, state, toks, self.cfg, ctx=ctx)
        with obs_rt.collecting(sink):
            return decode_step(params, state, toks, self.cfg, ctx=ctx)

    def _count_dispatch(self, sink, steps: int) -> None:
        """A burst's host-known counters: its steps, itself, its size's
        histogram bucket, and what its sink summed on the host."""
        host = self._ctr_host
        obs_rt.fold(self._ctr, sink, host)
        obs_rt.ctr_add(host, "decode_bursts", 1)
        obs_rt.ctr_add(host, "decode_steps", steps)
        bucket = min(max(steps.bit_length() - 1, 0), obs_rt.HIST_BUCKETS - 1)
        obs_rt.ctr_add(host, "burst_size_hist", 1, idx=bucket)

    def _drain(self) -> None:
        """One drain of the counters (the metrics layer's one host read)."""
        d0 = self.counters.drain_s
        self.counters.drain(self._ctr, self._ctr_host)
        if self.perf is not None:
            self.perf.record("drain", self.counters.drain_s - d0,
                             tracer=self.tracer)

    def _after_burst(self, steps: int) -> None:
        """The burst cadence: a drain every ``drain_every`` bursts, then
        the drift monitor's tap."""
        self._burst_i += 1
        de = self._obs.drain_every if self._obs is not None else 0
        if self._obs_counters and de and self._burst_i % de == 0:
            with self.tracer.span("drain", cat="obs", tid=ENGINE_TID):
                self._drain()
        if self._drift is not None:
            self._drift.observe(steps)

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fresh_state(self) -> DecodeState:
        if self._paged:
            return init_paged_decode_state(
                self.cfg, self._pcfg, self.ecfg.max_slots, self._kv_ranges,
                device=self.device,
                mesh=self.ecfg.mesh if self._kv_shards > 1 else None)
        return init_decode_state(self.cfg, self.ecfg.max_slots,
                                 self.ecfg.max_len, per_slot_pos=True,
                                 device=self.device)

    def _fresh_draft_state(self, state: DecodeState) -> DecodeState:
        """The draft lane's KV state: paged, a second set of pools at the
        draft width whose page table and write limits ARE the serving
        state's tensors (updated in place, so the lanes mirror each other
        page for page); dense, a per-slot cache on the static-scale int8
        grid (or fp at 16 bits)."""
        ecfg = self.ecfg
        if self._paged:
            st = init_paged_decode_state(self.cfg, self._dpcfg,
                                         ecfg.max_slots, self._kv_ranges,
                                         device=self.device)
            return st._replace(paged=st.paged._replace(
                table=state.paged.table, write_limit=state.paged.write_limit))
        return init_decode_state(
            self.cfg, ecfg.max_slots, ecfg.max_len, per_slot_pos=True,
            device=self.device,
            kv_dtype=torch.int8 if self._spec.draft_kv_bits == 8 else None)

    @staticmethod
    def _mode_for(sampling_params) -> str:
        """The cheapest sampler specialization that serves these requests
        exactly (a row's tokens are the same in every mode serving it)."""
        if all(s.temperature <= 0 for s in sampling_params):
            return "greedy"
        if all(s.top_k <= 0 and s.top_p >= 1 for s in sampling_params):
            return "nofilter"
        return "full"

    def _active_mode(self) -> str:
        return self._mode_for([self._slots[b].sampling
                               for b in np.flatnonzero(self._active)])

    def _sample(self, logits: torch.Tensor, mode: str,
                token_idx: Optional[torch.Tensor],
                rows: slice = slice(None)) -> torch.Tensor:
        """(R[, CB], V) logits of the slots ``rows`` -> (R[, CB]) int32
        tokens; ``token_idx`` (R,) is the index of the token each samples
        (its key)."""
        if mode == "greedy":
            return greedy_tokens(logits)
        return sample_tokens(logits, request_keys(self._seeds[rows], token_idx),
                             self._temps[rows], self._top_ks[rows],
                             self._top_ps[rows],
                             skip_filters=mode == "nofilter")

    def _per_token(self, t: torch.Tensor) -> torch.Tensor:
        """A per-slot (S,) tensor shaped (S, 1[, 1]) to broadcast against
        the slots' (S, 1[, CB]) tokens."""
        return t.reshape((-1, 1) + (1,) * len(self._cb))

    def _now(self) -> float:
        if self.ecfg.clock == "wall":
            return time.perf_counter() - self._t0
        return float(self._ticks)

    def _advance_to(self, t: float) -> None:
        if self.ecfg.clock == "wall":
            dt = t - self._now()
            if dt > 0:
                time.sleep(min(dt, 0.05))
        else:
            self._ticks = max(self._ticks, int(math.ceil(t)))

    def _start_run(self) -> None:
        """Fresh run state: the caches, the device slot table and sampling
        tables, the host scheduler's mirrors, metrics and counters."""
        ecfg, S = self.ecfg, self.ecfg.max_slots
        dev = self.device
        self._state = self._fresh_state()
        self._tok = torch.zeros((S, 1) + self._cb, dtype=torch.int32,
                                device=dev)
        # per-slot sampling tables, written at admission
        self._seeds = torch.zeros(S, dtype=torch.int32, device=dev)
        self._temps = torch.zeros(S, dtype=torch.float32, device=dev)
        self._top_ks = torch.zeros(S, dtype=torch.int32, device=dev)
        self._top_ps = torch.ones(S, dtype=torch.float32, device=dev)
        # the device slot table (active, tokens written, token budget):
        # written at admission and eviction, advanced on the device by the
        # bursts; the numpy mirrors below are the scheduler's
        self._dactive = torch.zeros(S, dtype=torch.bool, device=dev)
        self._dnw = torch.zeros(S, dtype=torch.int64, device=dev)
        self._dbudget = torch.zeros(S, dtype=torch.int64, device=dev)
        if self._spec is not None:
            self._dstate = self._fresh_draft_state(self._state)
            self._ptok = torch.zeros((S, 1) + self._cb, dtype=torch.int32,
                                     device=dev)
        self.spec_stats = {"proposed": 0, "accepted": 0, "dispatches": 0}
        self._out = np.zeros((S, ecfg.max_new_tokens) + self._cb, np.int32)
        self._slots: List[Optional[Request]] = [None] * S
        self._active = np.zeros(S, bool)
        self._nwritten = np.zeros(S, np.int64)
        self._budget = np.zeros(S, np.int64)
        if self._paged:
            self._alloc = BlockAllocator(self._pcfg.num_pages,
                                         self._pcfg.page_size,
                                         prefix_sharing=self._share)
            self._rows: List[List[int]] = [[] for _ in range(S)]
            self._pos_h = np.zeros(S, np.int64)
            self._limit_h = np.zeros(S, np.int64)
            self._page_bytes = page_bytes_all_layers(self.cfg, self._pcfg)
        self._ticks = 0
        self._t0 = time.perf_counter()
        self.metrics = EngineMetrics(max_slots=S)
        if self._paged:
            self.metrics.kv_total_pages = self._pcfg.num_pages
            self.metrics.kv_page_bytes = self._page_bytes
        self._ctr = self._fresh_counters()
        self._ctr_host = obs_rt.init_host_counters() if self._ctr else {}
        self._burst_i = 0

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request]
            ) -> Tuple[List[Request], EngineMetrics]:
        """Serve ``requests`` to completion; returns (finished, metrics)."""
        ecfg, S = self.ecfg, self.ecfg.max_slots
        self._start_run()
        run_sid = self.tracer.begin("run", cat="engine", tid=ENGINE_TID) \
            if self.tracer.enabled else None
        finished: List[Request] = []
        pending = collections.deque(
            sorted(requests, key=lambda r: (r.arrival_time, r.id)))

        with torch.no_grad():
            while pending or self._active.any():
                n_arrived = 0
                for r in pending:
                    if r.arrival_time > self._now():
                        break
                    n_arrived += 1
                self._runnable = min(S, int(self._active.sum()) + n_arrived)
                while (pending and not self._active.all()
                       and pending[0].arrival_time <= self._now()):
                    if not self._admit(pending[0]):
                        # KV pool full: defer, keep decoding to free pages
                        self.metrics.record_deferral()
                        self.tracer.event("admission_deferred",
                                          req=pending[0].id,
                                          pages_free=self._alloc.available())
                        break
                    pending.popleft()
                    self._harvest(finished)
                if not self._active.any():
                    if pending:
                        if (self._paged
                                and pending[0].arrival_time <= self._now()):
                            raise RuntimeError(
                                f"KV page pool ({self._pcfg.num_pages} pages) "
                                f"cannot hold request {pending[0].id} even "
                                "with every slot idle — raise kv_pages or "
                                "lower max_new_tokens")
                        self._advance_to(pending[0].arrival_time)
                    continue
                # size the burst by the soonest-finishing slot, floored at
                # 4 steps; never decode past the next arrival when a slot
                # is free (step clock)
                remaining = (self._budget - self._nwritten)[self._active]
                k = min(ecfg.decode_burst, int(remaining.min()))
                if k < 4:
                    k = min(ecfg.decode_burst, 4, int(remaining.max()))
                if (pending and not self._active.all()
                        and ecfg.clock == "steps"):
                    gap = pending[0].arrival_time - self._now()
                    if gap > 0:
                        k = max(1, min(k, int(math.ceil(gap))))
                self._burst(max(k, 1))
                self._harvest(finished)
        if self._obs_counters:
            self._drain()                        # the final drain
            self.tracer.event("drain", n=self.counters.n_drains)
        if run_sid is not None:
            self.tracer.end(run_sid, {"requests": len(finished),
                                      "deferrals":
                                      self.metrics.admission_deferrals})
        finished.sort(key=lambda r: r.id)
        return finished, self.metrics

    # ------------------------------------------------------------------
    def _plan_pages(self, slot: int, req: Request):
        """Allocator side of paged admission: match the prompt's prefix
        against resident pages, claim/allocate, and reserve the decode
        growth. Returns ``(shared_len, partial_src, row, gather_ids)``,
        or None (admission deferred) if the pool cannot also cover the
        request's worst-case decode."""
        alloc, page = self._alloc, self._pcfg.page_size
        plen = req.prompt_len
        limit = min(plen + req.max_new_tokens, self.ecfg.max_len)
        total_pages = -(-limit // page)
        # at least one prompt token is always prefilled (cap plen - 1)
        full_ids, shared_len, partial_src = alloc.match_prefix(
            np.asarray(req.prompt), plen - 1)
        n_prompt_pages = -(-plen // page)
        new_now = n_prompt_pages - len(full_ids)
        future = total_pages - n_prompt_pages
        if alloc.available() < new_now + future:
            return None
        alloc.claim(full_ids)
        fresh = alloc.allocate(new_now)
        alloc.reserve(slot, future)
        alloc.shared_tokens += shared_len
        if partial_src is not None:
            alloc.cow_copies += 1
        row = list(full_ids) + list(fresh)
        gather_ids = list(full_ids) + ([partial_src]
                                       if partial_src is not None else [])
        return shared_len, partial_src, row, gather_ids

    def _pad_row(self, ids: List[int]) -> torch.Tensor:
        row = np.full(self._pcfg.pages_per_slot, self._pcfg.num_pages, np.int32)
        row[:len(ids)] = ids
        return torch.as_tensor(row).to(self.device)

    def _gather_prefix(self, pstate: DecodeState, row: torch.Tensor,
                       shared_len: int) -> None:
        """Shared prefix pages -> the dense batch-1 scratch cache (in
        place): suffix prefill attends to it without recomputation."""
        for i in range(self._n_kv_layers):
            kg, vg = gather_layer(self._state.paged.layers[str(i)], row,
                                  shared_len, self.cfg.param_dtype)
            pstate.kv.k[i, 0] = kg
            pstate.kv.v[i, 0] = vg
        pstate.pos.fill_(shared_len)

    def _admit(self, req: Request) -> bool:
        ecfg, cfg = self.ecfg, self.cfg
        slot = int(np.flatnonzero(~self._active)[0])
        if req.prompt_len >= ecfg.max_len:
            raise ValueError(
                f"request {req.id}: prompt ({req.prompt_len}) does not fit "
                f"the engine's max_len ({ecfg.max_len})")
        budget = min(ecfg.max_len - req.prompt_len, ecfg.max_new_tokens)
        if req.max_new_tokens > budget:
            log.warning("request %d: max_new_tokens %d clipped to %d",
                        req.id, req.max_new_tokens, budget)
            req.max_new_tokens = budget
        shared_len, partial_src, row, gather_ids = 0, None, None, None
        if self._paged:
            plan = self._plan_pages(slot, req)
            if plan is None:
                return False
            shared_len, partial_src, row, gather_ids = plan
        req.slot, req.status = slot, RequestStatus.PREFILLING
        req.t_admitted = self._now()
        tr = self.tracer
        rtid = tr.request_tid(req.id) if tr.enabled else ENGINE_TID
        if tr.enabled:
            # the request's lifecycle span (its own track in Perfetto),
            # closed at eviction in _harvest
            req.obs_span = tr.begin(f"request {req.id}", cat="request",
                                    tid=rtid,
                                    args={"prompt_len": req.prompt_len})
        admit_sid = tr.begin("admit", cat="admit", tid=rtid) \
            if tr.enabled else None

        pstate = init_decode_state(cfg, 1, ecfg.max_len, device=self.device)
        if shared_len > 0:
            # prefix reuse: seed the scratch cache from the shared pages
            # and prefill only the suffix
            with tr.span("gather_prefix", cat="admit", tid=rtid,
                         args={"shared_len": shared_len}):
                self._gather_prefix(pstate, self._pad_row(gather_ids),
                                    shared_len)
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32))[None].to(
            self.device)
        logits = None
        for lo in range(shared_len, req.prompt_len, ecfg.prefill_chunk):
            chunk = prompt[:, lo:lo + ecfg.prefill_chunk]
            t0 = time.perf_counter()
            span = DeviceSpan(self.device) if self.perf is not None else None
            sid = tr.begin("prefill_chunk", cat="prefill", tid=rtid) \
                if tr.enabled else None
            logits, pstate = prefill_into(self.params, pstate, chunk, cfg,
                                          ctx=self._ctx)
            if span is not None:
                span.stop()
            self._sync()
            dt = time.perf_counter() - t0
            if sid is not None:
                tr.end(sid, {"tokens": int(chunk.shape[1]), "lo": lo})
            if self.perf is not None:
                dev_s, compiled = span.read()
                self.perf.record("prefill_chunk", dt,
                                 tokens=int(chunk.shape[1]),
                                 compiled=compiled, tracer=tr,
                                 device_s=dev_s)
            self.metrics.record_prefill(dt, chunk.shape[1])
            if ecfg.clock == "steps":
                self._ticks += chunk.shape[1]
            if (ecfg.interleave_steps
                    and int(self._active.sum()) >= max(1, ecfg.max_slots - 1)
                    and lo + ecfg.prefill_chunk < req.prompt_len):
                rem = (self._budget - self._nwritten)[self._active]
                self._burst(min(ecfg.interleave_steps, int(rem.min())))

        s = req.sampling
        self._seeds[slot] = s.seed
        self._temps[slot] = s.temperature
        self._top_ks[slot] = s.top_k
        self._top_ps[slot] = s.top_p
        # the first token: the key of token index 0
        tok0 = self._sample(logits[:, -1, ..., :cfg.vocab_size],
                            self._mode_for([s]),
                            torch.zeros(1, dtype=torch.int64, device=self.device),
                            rows=slice(slot, slot + 1))
        st = self._state
        if self._paged:
            plen = req.prompt_len
            limit = min(plen + req.max_new_tokens, ecfg.max_len)
            drow = self._pad_row(row)
            ps = st.paged
            if partial_src is not None:
                # copy-on-write: own the partially filled boundary page
                # before the suffix insert writes into it
                dst = row[len(gather_ids) - 1]
                for lp in ps.layers.values():
                    copy_page(lp, partial_src, dst)
            # tokens < shared_len are already in the shared pages
            for i in range(self._n_kv_layers):
                scatter_span(ps.layers[str(i)], drow, pstate.kv.k[i, 0],
                             pstate.kv.v[i, 0], shared_len, plen)
            st.pos[slot] = plen
            insert_ssm_slot(cfg, st, pstate, slot)
            ps.table[slot] = drow
            ps.write_limit[slot] = limit
            self._alloc.register_prompt(np.asarray(req.prompt), row, plen)
            self._rows[slot] = row
            self._pos_h[slot] = plen
            self._limit_h[slot] = limit
            self.metrics.record_kv_usage(self._alloc.pages_in_use)
            self.metrics.kv_shared_tokens = self._alloc.shared_tokens
            self.metrics.kv_cow_copies = self._alloc.cow_copies
        else:
            state_insert_slot(cfg, st, pstate, slot)
        if self._spec is not None:
            self._insert_draft(req, slot, pstate, shared_len, partial_src,
                               row, gather_ids)
        self._tok[slot] = tok0
        self._out[slot, 0] = tok0.cpu().numpy()[0]
        self._dactive[slot] = True
        self._dnw[slot] = 1
        self._dbudget[slot] = req.max_new_tokens

        self._slots[slot] = req
        self._active[slot] = True
        self._nwritten[slot] = 1
        self._budget[slot] = req.max_new_tokens
        req.t_first_token = self._now()
        req.status = RequestStatus.RUNNING
        if admit_sid is not None:
            tr.end(admit_sid, {"slot": slot, "shared_len": shared_len})
        tr.event("admit", req=req.id, slot=slot, shared_len=shared_len,
                 prompt_len=req.prompt_len)
        return True

    def _insert_draft(self, req: Request, slot: int, pstate: DecodeState,
                      shared_len: int, partial_src, row, gather_ids) -> None:
        """Seed the draft lane at admission from the same prefilled
        scratch state: the serving prefill's KV on the draft lane's grid,
        so the draft attends to the whole prompt from its first step. The
        lane starts one position BEHIND the serving stream: the first
        dispatch's catch-up pair lands on the last prompt token."""
        plen = req.prompt_len
        dst = self._dstate
        if self._paged:
            ps = dst.paged
            if partial_src is not None:
                # mirror the serving copy-on-write before the suffix
                # scatter writes into the owned boundary page
                for lp in ps.layers.values():
                    copy_page(lp, partial_src, row[len(gather_ids) - 1])
            drow = self._pad_row(row)
            for i in range(self._n_kv_layers):
                scatter_span(ps.layers[str(i)], drow, pstate.kv.k[i, 0],
                             pstate.kv.v[i, 0], shared_len, plen)
            dst.pos[slot] = plen - 1
        else:
            dkb = self._spec.draft_kv_bits
            sub = DecodeState(pos=pstate.pos - 1, kv=KVCache(
                quantize_dense_kv(pstate.kv.k, dkb),
                quantize_dense_kv(pstate.kv.v, dkb)))
            state_insert_slot(self.cfg, dst, sub, slot)
        # the catch-up pair's first element: the last prompt token
        self._ptok[slot] = torch.as_tensor(
            np.asarray(req.prompt, np.int32)[-1:]).to(self.device)

    # ------------------------------------------------------------------
    def _grow_tables(self, steps: int) -> None:
        """Extend each active slot's page row to cover its next ``steps``
        writes (admission reserved the pages) and upload the table once."""
        page = self._pcfg.page_size
        grew = False
        for b in np.flatnonzero(self._active):
            need = -(-min(self._pos_h[b] + steps, self._limit_h[b]) // page)
            have = len(self._rows[b])
            if need <= have:
                continue
            ids = self._alloc.allocate(need - have, owner=int(b))
            if ids is None:
                raise RuntimeError("page reservation accounting broken")
            self._rows[b] += ids
            grew = True
        if grew:
            table = np.full((self.ecfg.max_slots, self._pcfg.pages_per_slot),
                            self._pcfg.num_pages, np.int32)
            for b in np.flatnonzero(self._active):
                table[b, :len(self._rows[b])] = self._rows[b]
            self._state.paged.table.copy_(torch.as_tensor(table))
            self.metrics.record_kv_usage(self._alloc.pages_in_use)

    def _burst(self, steps: int) -> None:
        if steps <= 0:
            return
        if self._spec is not None:
            # every decode burst is a draft/verify dispatch (a plain burst
            # would advance the serving lane without the draft lane); the
            # per-slot budget clamp absorbs the caller's bound
            return self._spec_burst()
        steps = 1 << (steps.bit_length() - 1)    # a power of two, as upstream
        if self._paged:
            self._grow_tables(steps)
        n_active = int(self._active.sum())
        mode = self._active_mode()
        tr = self.tracer
        timed = tr.enabled or self.perf is not None
        sid = tr.begin("decode_burst", cat="decode", tid=ENGINE_TID) \
            if tr.enabled else None
        sink = self._sink()
        t0 = time.perf_counter()
        span = DeviceSpan(self.device) if timed else None
        ys = self._engine_step(steps, mode, sink)
        if span is not None:
            span.stop()
        # rpr-ok: RPR008 the burst's one host read: the tokens the scheduler needs
        ys = ys.cpu().numpy()
        wall = time.perf_counter() - t0
        before = self._nwritten[self._active]
        after = np.minimum(before + steps, self._budget[self._active])
        for b, n0, n1 in zip(np.flatnonzero(self._active), before, after):
            self._out[b, n0:n1] = ys[:n1 - n0, b]
        self._nwritten[self._active] = after
        if self._paged:
            self._pos_h[self._active] += steps
        n_tokens = int((after - before).sum())
        self._record_burst("decode_burst", sid, span, wall, steps, n_active,
                           n_tokens, [int(x) for x in after - before],
                           {"steps": steps, "mode": mode})

    def _engine_step(self, steps: int, mode: str, sink) -> torch.Tensor:
        """The device work of one decode burst, with no host read: ``steps``
        decode steps over every slot (inactive slots ride along with
        frozen positions), the sampled tokens, and the device slot table's
        advance. Returns the (steps, S[, CB]) tokens on the device."""
        cfg = self.cfg
        active, nw = self._dactive, self._dnw
        act_tok = self._per_token(active)
        ys = []
        state, tok = self._state, self._tok
        for i in range(steps):
            logits, new = self._decode(sink, self.params, state, tok, self._ctx)
            state = new._replace(pos=torch.where(active, new.pos, state.pos))
            nxt = self._sample(logits[:, 0, ..., :cfg.vocab_size], mode,
                               None if mode == "greedy" else nw + i)
            tok = torch.where(act_tok, nxt[:, None], tok)
            ys.append(nxt)
        # the device slot table advances as the output scatter clamps:
        # an active slot writes min(steps, budget - written) useful tokens
        adv = torch.where(active, torch.clamp(self._dbudget - nw, 0, steps),
                          torch.zeros_like(nw))
        if sink is not None:
            obs_rt.ctr_add(self._ctr, "decode_tokens", torch.sum(adv))
            self._count_dispatch(sink, steps)
        nw += adv
        self._state, self._tok = state, tok
        return torch.stack(ys)

    def _record_burst(self, kind: str, sid, span, wall: float, steps: int,
                      n_active: int, n_tokens: int, per_slot: List[int],
                      args: Dict) -> None:
        """After a burst's host read: its span, its timing sample, its
        metrics, the clock, then the drain and drift cadence."""
        dev_s, compiled = span.read() if span is not None else (None, False)
        if sid is not None:
            self.tracer.end(sid, dict(args, n_active=n_active,
                                      tokens=n_tokens, tp=self._tp,
                                      compiled=compiled))
        if self.perf is not None:
            self.perf.record(kind, wall, tokens=n_tokens, compiled=compiled,
                             tracer=self.tracer, device_s=dev_s,
                             args=dict(args, n_active=n_active))
        self.metrics.record_burst(wall, steps, n_active, n_tokens=n_tokens,
                                  n_runnable=max(n_active, self._runnable),
                                  per_slot_tokens=per_slot)
        if self.ecfg.clock == "steps":
            self._ticks += steps
        self._after_burst(steps)

    def _spec_burst(self) -> None:
        """One draft/verify dispatch. The draft lane lags the emitted
        stream by one position: a fused 2-token catch-up over the last
        two stream tokens (rewriting the lag position's KV with the same
        bits and writing the KV the previous dispatch's last token never
        got) proposes d_1, then k - 1 one-token steps propose d_2..d_k;
        ONE (k+1)-token verify of the serving config re-samples every
        column i with the key of token index nwritten + i; the matched
        prefix plus the correction-or-bonus token is emitted; both lanes
        roll back by position. The dispatch's one host read is the
        emitted tokens, which the scheduler needs."""
        k = self._spec.k
        if self._paged:
            # the verify writes up to k + 1 serving positions (the draft
            # lane writes through the same table)
            self._grow_tables(k + 1)
        n_active = int(self._active.sum())
        mode = self._active_mode()
        tr = self.tracer
        timed = tr.enabled or self.perf is not None
        sid = tr.begin("spec_burst", cat="decode", tid=ENGINE_TID) \
            if tr.enabled else None
        sink = self._sink()
        t0 = time.perf_counter()
        span = DeviceSpan(self.device) if timed else None
        host = self._spec_step(mode, sink, n_active)
        if span is not None:
            span.stop()
        tgt_shape = (host.shape[0], k + 1) + self._cb
        # rpr-ok: RPR008 the dispatch's one host read: the emitted tokens
        host = host.cpu().numpy()
        wall = time.perf_counter() - t0
        ne, tgt_h = host[:, 0], host[:, 1:].reshape(tgt_shape)
        for b in np.flatnonzero(self._active):
            n0 = self._nwritten[b]
            self._out[b, n0:n0 + ne[b]] = tgt_h[b, :ne[b]]
        self._nwritten[self._active] += ne[self._active]
        if self._paged:
            self._pos_h[self._active] += ne[self._active]
        n_tokens = int(ne.sum())
        self.spec_stats["dispatches"] += 1
        self.spec_stats["proposed"] += k * n_active
        # emitted minus the always-emitted correction token: undercounts
        # only where the budget clamp cut a matched run
        self.spec_stats["accepted"] += int(
            np.maximum(ne[self._active] - 1, 0).sum())
        self._record_burst("spec_burst", sid, span, wall, k + 1, n_active,
                           n_tokens, [int(x) for x in ne[self._active]],
                           {"k": k, "mode": mode})

    def _spec_step(self, mode: str, sink, n_active: int) -> torch.Tensor:
        """The device work of one draft/verify dispatch, with no host read:
        k draft invocations, the (k+1)-token verify, the coupled accept,
        both lanes' rollback and the device slot table's advance. Returns
        the (S, 1 + (k+1)[·CB]) host fetch: each slot's emitted count, then
        its verify tokens."""
        k, V = self._spec.k, self.cfg.vocab_size
        active, nw, budget = self._dactive, self._dnw, self._dbudget
        act_tok = self._per_token(active)
        state, dstate, tok = self._state, self._dstate, self._tok

        def draft_step(dst, toks):
            lg, dnew = self._decode(sink, self._draft_params, dst, toks,
                                    self._dctx)
            return lg, dnew._replace(pos=torch.where(active, dnew.pos,
                                                     dst.pos))

        # ---- draft: k proposals from k invocations ----
        lg2, dst = draft_step(dstate, torch.cat([self._ptok, tok], dim=1))
        drafts = [self._sample(lg2[:, 1, ..., :V], mode, nw)]
        dtok = torch.where(act_tok, drafts[0][:, None], tok)
        for i in range(1, k):
            lg, dst = draft_step(dst, dtok)
            drafts.append(self._sample(lg[:, 0, ..., :V], mode, nw + i))
            dtok = torch.where(act_tok, drafts[-1][:, None], dtok)
        drafts = torch.stack(drafts, dim=1)                    # (S, k[, CB])

        # ---- verify: one (k+1)-token forward of the serving config ----
        logits, vnew = self._decode(sink, self.params, state,
                                    torch.cat([tok, drafts], dim=1),
                                    self._ctx)
        tgt = torch.stack([self._sample(logits[:, i, ..., :V], mode, nw + i)
                           for i in range(k + 1)], dim=1)      # (S, k+1[, CB])
        n_emit, n_match = accept_drafts(drafts, tgt, active, nw, budget)

        # next input: the last emitted token; the catch-up pair's first
        # element: the one before it (the old input when one was emitted);
        # both frozen where nothing was emitted
        def column(back):
            idx = self._per_token(torch.clamp_min(n_emit - back, 0))
            return torch.gather(tgt, 1, idx.expand((-1, 1) + self._cb))

        last, before = column(1), column(2)
        emitted = self._per_token(n_emit > 0)
        self._ptok = torch.where(
            emitted, torch.where(self._per_token(n_emit >= 2), before, tok),
            self._ptok).to(torch.int32)
        self._tok = torch.where(emitted, last, tok).to(torch.int32)
        # rollback: both lanes rewind to P + n_emit; rejected KV writes
        # stay past that position, masked, and are overwritten later
        step = n_emit.to(state.pos.dtype)
        self._state = vnew._replace(pos=state.pos + step)
        self._dstate = dst._replace(pos=dstate.pos + step)
        if sink is not None:
            # exact device tallies: useful tokens and matched drafts
            obs_rt.ctr_add(self._ctr, "decode_tokens", torch.sum(n_emit))
            obs_rt.ctr_add(self._ctr, "spec_accepted", torch.sum(
                torch.where(active, n_match, torch.zeros_like(n_match))))
            obs_rt.ctr_add(self._ctr_host, "spec_proposed", k * n_active)
            self._count_dispatch(sink, k + 1)
        nw += n_emit

        return torch.cat([n_emit[:, None],
                          tgt.reshape(tgt.shape[0], -1).to(n_emit.dtype)], dim=1)

    # ------------------------------------------------------------------
    def _harvest(self, finished: List[Request]) -> None:
        """Evict finished slots (token budget or EOS) and record them."""
        if not self._active.any():
            return
        for b in np.flatnonzero(self._active):
            req = self._slots[b]
            count = int(self._nwritten[b])
            done = count >= self._budget[b]
            toks = self._out[b, :count].copy()
            if req.eos_id is not None:
                # audio: the first codebook carries the end of stream
                flat = toks if toks.ndim == 1 else toks[:, 0]
                hits = np.flatnonzero(flat == req.eos_id)
                if hits.size:
                    toks = toks[:hits[0] + 1]
                    done = True
            if not done:
                continue
            req.output_tokens = toks
            req.t_finished = self._now()
            req.status = RequestStatus.FINISHED
            self.metrics.record_request(req)
            finished.append(req)
            tr = self.tracer
            evict_sid = tr.begin("evict", cat="evict",
                                 tid=tr.request_tid(req.id),
                                 args={"slot": int(b)}) \
                if tr.enabled else None
            self._slots[b] = None
            self._active[b] = False
            self._dactive[b] = False
            if self._paged:
                self.metrics.record_kv_request(
                    len(self._rows[b]) * self._page_bytes)
                self._alloc.release(self._rows[b])
                self._alloc.unreserve(int(b))
                self._rows[b] = []
                self._pos_h[b] = self._limit_h[b] = 0
                ps = self._state.paged
                ps.table[b] = self._pcfg.num_pages
                ps.write_limit[b] = 0
            if evict_sid is not None:
                tr.end(evict_sid)
                if req.obs_span is not None:
                    tr.end(req.obs_span, {"tokens": int(len(toks))})
            tr.event("finish", req=req.id, slot=int(b),
                     tokens=int(len(toks)))
