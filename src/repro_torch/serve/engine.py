"""Continuous-batching inference engine (port of ``repro.serve.engine``).

    loadgen ──> arrival queue ──> admission ──> slots [0..S) ──> finished
                                   │                 ▲
                                   │ chunked prefill │ eviction on
                                   ▼ (batch-1 loop)  │ EOS / budget,
                                 insert into slot ───┘ immediate backfill

A request is prefilled alone (batch 1) in chunks into a dense scratch
state, then inserted into its slot: copied into the dense batched cache,
or scattered into freshly allocated pages (``kv_cache="paged"``). Decode
bursts run ``decode_step`` over all slots; inactive slots ride along
with frozen positions (paged writes past a slot's limit are dropped).
Every batch row is computed independently — per-row activation scales
on the ``qmm`` route, per-row cache writes and masks — so a request's
tokens equal those of the same request served alone.

Ported: greedy decoding, dense and paged KV, chunked prefill interleaved
with decode, page-table growth, eviction and backfill, admission
deferral when the page pool is full; the dense and MoE families (MoE
expert stacks through ``grouped_qmm``, or the per-expert ``qmm`` loop or
the fp einsum, by ``moe_dispatch``). On the MoE path the row
independence above stops at the experts' capacity, which couples a
token to its batch-mates as it does in the reference. Not yet ported
(raise ``NotImplementedError``): sampled decoding, prefix sharing /
copy-on-write, speculative decoding, observability, tensor parallelism
and the ssm, hybrid, audio and vlm families.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import math
import time
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import ModelConfig
from repro_torch.kvcache.allocator import BlockAllocator
from repro_torch.kvcache.paged import (
    PagedKVConfig, kv_layer_count, page_bytes_all_layers, scatter_span)
from repro_torch.models.context import Context, DequantContext
from repro_torch.models.decode import (
    DecodeState, decode_step, init_decode_state, init_paged_decode_state,
    prefill_into, state_insert_slot)
from repro_torch.models.transformer import require_ported_family
from repro_torch.qtensor import tree_has_qtensor
from repro_torch.serve.metrics import EngineMetrics
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
    int8_compute: bool = False    # route QTensor blocks through ops.qmm
    # packed MoE expert stacks (int8_compute only): "grouped" (one
    # grouped_qmm per projection), "dense" (per-expert qmm loop, the
    # bit-identity oracle) or "einsum" (fp-dequant batched einsum)
    moe_dispatch: str = "grouped"
    # ---- paged KV cache ----
    kv_cache: str = "dense"       # "dense" | "paged"
    page_size: int = 16
    kv_pages: Optional[int] = None
    prefix_sharing: bool = False  # not ported yet: True raises
    # ---- not ported yet: anything but None raises ----
    mesh: Optional[object] = None
    obs: Optional[object] = None
    spec: Optional[object] = None


def _check_supported(cfg: ModelConfig, ecfg: EngineConfig, scales) -> None:
    for field in ("spec", "obs", "mesh"):
        if getattr(ecfg, field) is not None:
            raise NotImplementedError(
                f"EngineConfig.{field} is not ported to repro_torch yet")
    if ecfg.prefix_sharing:
        raise NotImplementedError(
            "prefix sharing / copy-on-write is not ported yet "
            "(EngineConfig(prefix_sharing=False))")
    require_ported_family(cfg)
    if scales:
        raise NotImplementedError(
            "legacy int8 + scales storage is not ported; use quantize_params")
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
        """``kv_bits`` (paged): None/int uniform or {layer -> bits} from
        ``kvcache.fit.allocate_kv_bits``; ``kv_ranges``: calibrated
        activation ranges for the per-page scales. ``device`` defaults to
        the GPU."""
        _check_supported(cfg, ecfg, scales)
        self.device = resolve_device(device)
        self.params = map_with_names(lambda _, leaf: leaf.to(self.device), params)
        self.cfg = cfg
        self.ecfg = ecfg
        self._ctx = (DequantContext(None, cfg.param_dtype,
                                    int8_compute=ecfg.int8_compute,
                                    moe_dispatch=ecfg.moe_dispatch)
                     if tree_has_qtensor(params) else Context())
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
            return init_paged_decode_state(self.cfg, self._pcfg,
                                           self.ecfg.max_slots,
                                           self._kv_ranges, device=self.device)
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
                                         prefix_sharing=False)
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
        """Allocate the prompt's pages and reserve its decode growth;
        None (admission deferred) if the pool cannot cover both."""
        alloc, page = self._alloc, self._pcfg.page_size
        plen = req.prompt_len
        limit = min(plen + req.max_new_tokens, self.ecfg.max_len)
        total_pages = -(-limit // page)
        n_prompt_pages = -(-plen // page)
        future = total_pages - n_prompt_pages
        if alloc.available() < n_prompt_pages + future:
            return None
        row = alloc.allocate(n_prompt_pages)
        alloc.reserve(slot, future)
        return row

    def _pad_row(self, ids: List[int]) -> torch.Tensor:
        row = np.full(self._pcfg.pages_per_slot, self._pcfg.num_pages, np.int32)
        row[:len(ids)] = ids
        return torch.as_tensor(row).to(self.device)

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
        row = None
        if self._paged:
            row = self._plan_pages(slot, req)
            if row is None:
                return False
        req.slot, req.status = slot, RequestStatus.PREFILLING
        req.t_admitted = self._now()

        pstate = init_decode_state(cfg, 1, ecfg.max_len, device=self.device)
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32))[None].to(
            self.device)
        logits = None
        for lo in range(0, req.prompt_len, ecfg.prefill_chunk):
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
            for i in range(self._n_kv_layers):
                scatter_span(ps.layers[str(i)], drow, pstate.kv.k[i, 0],
                             pstate.kv.v[i, 0], 0, plen)
            st.pos[slot] = plen
            ps.table[slot] = drow
            ps.write_limit[slot] = limit
            self._rows[slot] = list(row)
            self._pos_h[slot] = plen
            self._limit_h[slot] = limit
            self.metrics.record_kv_usage(self._alloc.pages_in_use)
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
