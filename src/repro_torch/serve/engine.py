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

Ported: greedy decoding, dense and paged KV, prefix sharing and
copy-on-write, chunked prefill interleaved with decode, page-table
growth, eviction and backfill, admission deferral when the page pool is
full; packed QTensor and int8-backed (path-keyed ``scales``) weights;
the dense and MoE families (MoE expert stacks through ``grouped_qmm``,
or the per-expert ``qmm`` loop or the fp einsum, by ``moe_dispatch``).
On the MoE path the row independence above stops at the experts'
capacity, which couples a token to its batch-mates as it does in the
reference.

Tensor-parallel serving (``EngineConfig(mesh=make_tp_mesh(N))``, a
``launch.mesh.TPMesh``): one process drives every shard, as the
reference's single controller does. ``serve.quantized.shard_params``
splits the quantized blocks column-, row- or expert-wise across the
mesh's devices, ``ShardedDequantContext`` runs them shard by shard, and
(paged, when the kv heads divide the mesh) the page pools shard by kv
head; the scheduler, slot tables, token buffers and the dense scratch
state stay on the lead device. Every combine is an integer sum or a
concatenation in order, so an engine at any tp emits the tp=1 tokens.

Not yet ported (raise ``NotImplementedError``): sampled decoding,
speculative decoding, observability and the ssm, hybrid, audio and vlm
families.
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
from repro_torch.models.context import Context, ShardedDequantContext
from repro_torch.models.decode import (
    DecodeState, decode_step, init_decode_state, init_paged_decode_state,
    prefill_into, state_insert_slot)
from repro_torch.models.transformer import require_ported_family
from repro_torch.qtensor import tree_has_qtensor
from repro_torch.serve.metrics import EngineMetrics
from repro_torch.serve.quantized import make_dequant_context, shard_params
from repro_torch.serve.request import Request, RequestStatus
from repro_torch.serve.sampling import greedy_tokens
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
    # ---- not ported yet: anything but None raises ----
    obs: Optional[object] = None
    spec: Optional[object] = None


def _check_supported(cfg: ModelConfig, ecfg: EngineConfig) -> None:
    for field in ("spec", "obs"):
        if getattr(ecfg, field) is not None:
            raise NotImplementedError(
                f"EngineConfig.{field} is not ported to repro_torch yet")
    if ecfg.mesh is not None and not isinstance(ecfg.mesh, TPMesh):
        raise ValueError(
            f"EngineConfig.mesh must be a TPMesh (got {type(ecfg.mesh).__name__})"
            " — build it with repro_torch.launch.mesh.make_tp_mesh")
    require_ported_family(cfg)
    if ecfg.kv_cache not in ("dense", "paged"):
        raise ValueError(f"kv_cache must be dense|paged, got {ecfg.kv_cache!r}")
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
        self._paged = ecfg.kv_cache == "paged"
        self._pcfg: Optional[PagedKVConfig] = None
        self._kv_ranges = dict(kv_ranges) if kv_ranges else None
        if self._paged:
            self._pcfg = PagedKVConfig.build(
                cfg, ecfg.max_len, ecfg.max_slots, page_size=ecfg.page_size,
                num_pages=ecfg.kv_pages, kv_bits=kv_bits)
            self._n_kv_layers = kv_layer_count(cfg)

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

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request]
            ) -> Tuple[List[Request], EngineMetrics]:
        """Serve ``requests`` to completion; returns (finished, metrics)."""
        if any(r.sampling.temperature > 0 for r in requests):
            raise NotImplementedError(
                "sampled decoding (temperature > 0) is not ported yet")
        ecfg, S = self.ecfg, self.ecfg.max_slots
        self._state = self._fresh_state()
        self._tok = torch.zeros((S, 1), dtype=torch.int32, device=self.device)
        self._out = np.zeros((S, ecfg.max_new_tokens), np.int32)
        self._slots: List[Optional[Request]] = [None] * S
        self._active = np.zeros(S, bool)
        self._nwritten = np.zeros(S, np.int64)
        self._budget = np.zeros(S, np.int64)
        if self._paged:
            self._alloc = BlockAllocator(self._pcfg.num_pages,
                                         self._pcfg.page_size,
                                         prefix_sharing=ecfg.prefix_sharing)
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
                        self.metrics.record_deferral()
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

        pstate = init_decode_state(cfg, 1, ecfg.max_len, device=self.device)
        if shared_len > 0:
            # prefix reuse: seed the scratch cache from the shared pages
            # and prefill only the suffix
            self._gather_prefix(pstate, self._pad_row(gather_ids), shared_len)
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32))[None].to(
            self.device)
        logits = None
        for lo in range(shared_len, req.prompt_len, ecfg.prefill_chunk):
            chunk = prompt[:, lo:lo + ecfg.prefill_chunk]
            t0 = time.perf_counter()
            logits, pstate = prefill_into(self.params, pstate, chunk, cfg,
                                          ctx=self._ctx)
            self._sync()
            self.metrics.record_prefill(time.perf_counter() - t0,
                                        chunk.shape[1])
            if ecfg.clock == "steps":
                self._ticks += chunk.shape[1]
            if (ecfg.interleave_steps
                    and int(self._active.sum()) >= max(1, ecfg.max_slots - 1)
                    and lo + ecfg.prefill_chunk < req.prompt_len):
                rem = (self._budget - self._nwritten)[self._active]
                self._burst(min(ecfg.interleave_steps, int(rem.min())))

        tok0 = greedy_tokens(logits[:, -1, :cfg.vocab_size])      # (1,)
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
        self._tok[slot] = tok0
        self._out[slot, 0] = int(tok0.item())

        self._slots[slot] = req
        self._active[slot] = True
        self._nwritten[slot] = 1
        self._budget[slot] = req.max_new_tokens
        req.t_first_token = self._now()
        req.status = RequestStatus.RUNNING
        return True

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
        steps = 1 << (steps.bit_length() - 1)    # a power of two, as upstream
        if self._paged:
            self._grow_tables(steps)
        cfg = self.cfg
        n_active = int(self._active.sum())
        active = torch.as_tensor(self._active).to(self.device)
        t0 = time.perf_counter()
        ys = []
        state, tok = self._state, self._tok
        for _ in range(steps):
            logits, new = decode_step(self.params, state, tok, cfg, ctx=self._ctx)
            state = new._replace(pos=torch.where(active, new.pos, state.pos))
            nxt = greedy_tokens(logits[:, 0, :cfg.vocab_size])
            tok = torch.where(active[:, None], nxt[:, None], tok)
            ys.append(nxt)
        ys = torch.stack(ys).cpu().numpy()        # the burst's one sync
        wall = time.perf_counter() - t0
        self._state, self._tok = state, tok
        before = self._nwritten[self._active]
        after = np.minimum(before + steps, self._budget[self._active])
        for b, n0, n1 in zip(np.flatnonzero(self._active), before, after):
            self._out[b, n0:n1] = ys[:n1 - n0, b]
        self._nwritten[self._active] = after
        if self._paged:
            self._pos_h[self._active] += steps
        self.metrics.record_burst(wall, steps, n_active,
                                  n_tokens=int((after - before).sum()),
                                  n_runnable=max(n_active, self._runnable),
                                  per_slot_tokens=[int(x)
                                                   for x in after - before])
        if self.ecfg.clock == "steps":
            self._ticks += steps

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
                hits = np.flatnonzero(toks == req.eos_id)
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
            self._slots[b] = None
            self._active[b] = False
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
