"""Host-side block allocator for the paged KV cache (copy of
``repro.kvcache.allocator``).

Pure-Python page bookkeeping (the device never sees any of this — the
engine pushes the resulting page-table rows to the device as int32
arrays):

  * free-list recycling — pages return to a LIFO free list when their
    refcount drops to zero (eviction / request completion);
  * hash-based prefix sharing — full pages are indexed by the content
    hash of the ENTIRE token prefix they terminate (a page's KV values
    depend on every earlier token, so the hash must cover the whole
    prefix, not just the page's own chunk); a new prompt whose prefix
    hashes match simply increfs the existing pages and skips recomputing
    those tokens. The last, partially-filled page of a prompt is indexed
    too (keyed by its fill count) so identical prompts share all but the
    final recomputed token;
  * copy-on-write — a matched partial page is read-shared during
    admission and then physically copied before the new request writes
    its own suffix into it, so sharers never observe each other's
    writes;
  * reservation accounting — admission reserves the pages a request may
    still need during decode (up to its token budget), so a request that
    was admitted can always grow: the pool refuses new admissions rather
    than deadlocking mid-decode.

All prompt hashing uses the raw token bytes (works for (P,) token
vectors and (P, CB) audio codebook grids alike) and is computed in ONE
incremental walk per call — a page's key extends the previous page's
hash state by its own chunk, so a P-page prompt costs O(P·page) token
hashing, not the O(P²·page) that per-key full-prefix digests would.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

# REPRO_DEBUG_ALLOCATOR=1 turns on the O(pages) invariant self-check
# after every release/COW-relevant mutation (tests set it; serving
# doesn't pay for it by default)
_DEBUG = os.environ.get("REPRO_DEBUG_ALLOCATOR", "") not in ("", "0")


class BlockAllocator:
    """Page pool manager: refcounts, prefix index, reservations."""

    def __init__(self, num_pages: int, page_size: int,
                 prefix_sharing: bool = True):
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.prefix_sharing = prefix_sharing
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._ref = np.zeros(self.num_pages, np.int64)
        self._index: Dict[tuple, int] = {}      # content key -> page id
        self._key_of: Dict[int, List[tuple]] = {}   # page id -> its keys
        self._reserved: Dict[int, int] = {}     # owner -> pages held back
        # stats (peaks are tracked by EngineMetrics.record_kv_usage)
        self.shared_tokens = 0                  # prefill tokens skipped
        self.cow_copies = 0

    # ------------------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def available(self) -> int:
        """Pages free AND not reserved for admitted requests' decode."""
        return len(self._free) - sum(self._reserved.values())

    def refcount(self, pid: int) -> int:
        return int(self._ref[pid])

    # ------------------------------------------------------------------
    # prefix sharing
    # ------------------------------------------------------------------
    def _walk_keys(self, prompt: np.ndarray, n_tokens: int):
        """One incremental hash walk over ``prompt[:n_tokens]``.

        Returns ``(full_keys, partials)``: per page, the full-prefix key
        (None for the unfilled last page) and the list of ``(n, key)``
        partial keys for fill counts 1..min(fill, page-1). A key covers
        the ENTIRE prefix up to its position (a page's KV depends on
        every earlier token), but costs only its own tokens to extend.
        """
        ps = self.page_size
        prompt = np.ascontiguousarray(prompt[:n_tokens])
        h = hashlib.sha1()
        full_keys: List[Optional[tuple]] = []
        partials: List[List[tuple]] = []
        for i in range(-(-n_tokens // ps)):
            fill = min(n_tokens - i * ps, ps)
            page_partials = []
            for n in range(1, fill + 1):
                h.update(prompt[i * ps + n - 1:i * ps + n].tobytes())
                if n <= ps - 1:
                    page_partials.append((n, ("P", i, n, h.digest())))
            partials.append(page_partials)
            full_keys.append(("F", i, h.digest()) if fill == ps else None)
        return full_keys, partials

    def match_prefix(self, prompt: np.ndarray, cap: int
                     ) -> Tuple[List[int], int, Optional[int]]:
        """Longest indexed prefix of ``prompt`` (at most ``cap`` tokens).

        Returns ``(full_ids, shared_len, partial_src)``: the matched full
        pages, the total shared token count, and — if the next partial
        chunk also matched — the page to copy-on-write from. Pages are
        NOT claimed; call ``claim`` once admission is committed.
        """
        if not self.prefix_sharing or cap <= 0:
            return [], 0, None
        full_keys, partials = self._walk_keys(prompt, cap)
        full: List[int] = []
        i = 0
        while i < len(full_keys) and full_keys[i] is not None:
            pid = self._index.get(full_keys[i])
            if pid is None:
                break
            full.append(pid)
            i += 1
        shared = i * self.page_size
        partial_src = None
        if i < len(partials):
            for n, key in partials[i]:          # keep the LONGEST hit
                pid = self._index.get(key)
                if pid is not None:
                    partial_src, shared = pid, i * self.page_size + n
        return full, shared, partial_src

    def claim(self, ids: List[int]) -> None:
        """Incref shared pages (they survive their original owner)."""
        for pid in ids:
            assert self._ref[pid] > 0, f"claiming an unowned page {pid}"
            self._ref[pid] += 1

    def register_prompt(self, prompt: np.ndarray, page_ids: List[int],
                        plen: int) -> None:
        """Index the prompt's pages so later prompts can share them.

        Every page registers its full-prefix key plus a partial key per
        fill count 1..page-1 — a later prompt's BOUNDARY page may match
        any leading span of a resident page (a 12-token prompt shares 11
        tokens of a 20-token prompt's first page), and the boundary fill
        differs per prompt, so one key per page would almost never hit.
        Pages already carrying keys (they were shared into this prompt)
        are left alone.
        """
        if not self.prefix_sharing:
            return
        full_keys, partials = self._walk_keys(prompt, plen)
        for i in range(len(full_keys)):
            pid = page_ids[i]
            if pid in self._key_of:
                continue
            keys = [k for _, k in partials[i]]
            if full_keys[i] is not None:
                keys.append(full_keys[i])
            taken = [k for k in keys if k not in self._index]
            for k in taken:
                self._index[k] = pid
            if taken:
                self._key_of[pid] = taken

    # ------------------------------------------------------------------
    # allocation / reservations
    # ------------------------------------------------------------------
    def allocate(self, n: int, owner: Optional[int] = None
                 ) -> Optional[List[int]]:
        """Pop ``n`` fresh pages (refcount 1). ``owner`` draws down its
        reservation. Returns None if the pool cannot supply them."""
        if n <= 0:
            return []
        held = self._reserved.get(owner, 0) if owner is not None else 0
        # pages beyond this owner's reservation must come out of the
        # unreserved balance
        if len(self._free) - (sum(self._reserved.values()) - held) < n:
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._ref[ids] = 1
        if owner is not None:
            self._reserved[owner] = max(held - n, 0)
        return ids

    def reserve(self, owner: int, n: int) -> None:
        self._reserved[owner] = self._reserved.get(owner, 0) + max(n, 0)

    def unreserve(self, owner: int) -> None:
        self._reserved.pop(owner, None)

    def release(self, ids: List[int]) -> None:
        """Decref; pages reaching zero return to the free list and drop
        out of the prefix index."""
        for pid in ids:
            if self._ref[pid] <= 0:
                raise RuntimeError(f"releasing a free page {pid}")
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                for key in self._key_of.pop(pid, ()):
                    del self._index[key]
                self._free.append(pid)
        if _DEBUG:
            self.check_invariants()

    # ------------------------------------------------------------------
    # consistency
    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        """Full free-list / refcount / prefix-index / reservation audit.

        O(pages + index) — debug/test machinery, not hot-path code (the
        engine mutates the allocator once per admission/eviction, but
        serving latency tests still should not pay an O(pool) scan per
        request unless REPRO_DEBUG_ALLOCATOR is set). Raises
        AssertionError on the first violated invariant:

          1. the free list holds no duplicates and only valid page ids;
          2. a page is on the free list iff its refcount is zero
             (free ∩ referenced = ∅, and no leaked limbo pages);
          3. refcounts are never negative;
          4. the prefix index and the per-page key table are exact
             mirrors, and every indexed page is live (refcount > 0);
          5. reservations are non-negative and collectively no larger
             than the free pool (``available()`` cannot go negative).
        """
        free = self._free
        free_set = set(free)
        assert len(free_set) == len(free), (
            f"free list holds duplicates: {sorted(free)}")
        assert all(0 <= p < self.num_pages for p in free), (
            f"free list holds out-of-range ids: {sorted(free_set)}")
        assert (self._ref >= 0).all(), (
            f"negative refcount at pages "
            f"{np.flatnonzero(self._ref < 0).tolist()}")
        zero_ref = set(np.flatnonzero(self._ref == 0).tolist())
        assert free_set == zero_ref, (
            f"free list / refcount mismatch: free-but-referenced="
            f"{sorted(free_set - zero_ref)}, "
            f"unreferenced-but-not-free={sorted(zero_ref - free_set)}")
        for key, pid in self._index.items():
            assert pid in self._key_of and key in self._key_of[pid], (
                f"index key {key!r} -> page {pid} missing from _key_of")
            assert self._ref[pid] > 0, (
                f"prefix index points at free page {pid}")
        for pid, keys in self._key_of.items():
            for key in keys:
                assert self._index.get(key) == pid, (
                    f"_key_of[{pid}] lists key {key!r} not mapped back "
                    "by the index")
        assert all(n >= 0 for n in self._reserved.values()), (
            f"negative reservation: {self._reserved}")
        assert sum(self._reserved.values()) <= len(free), (
            f"reservations ({sum(self._reserved.values())}) exceed the "
            f"free pool ({len(free)})")
