"""KVPagePool: the serve engine's per-slot view of the paged KV cache (the
port's copy of ``repro.serving.kv_pool``; plain Python, no tensors but the
prompt it hashes).

Wraps ``core.paged_kv.PagedKVAllocator`` with what the engine needs per
request slot: a host mirror of the device page table, prefix hashing of
fused prompts (vision rows + tokens, chained per page so a hash names the
content of every position up to the page's end), admission that reuses
live or cold prefix pages by content, per-round ``ensure`` growth for
decode writes, release on eviction or preemption, and byte and shard
accounting for ``io_summary``.

Sharing discipline: only FULL prompt pages are content-addressed and
shared; the partial tail page and every decode-grown page are private to
their slot. Decode writes land at position ``length`` — past the full
prompt pages — so a shared page is never written after registration and no
copy-on-write runs on the hot path. A prompt of exactly ``max_seq`` tokens
has a full final page, but decode clamps its write position to ``max_seq -
1`` inside it, so that page stays private and unregistered
(``_shareable``).

Per-data-shard accounting: each page's "home" is the data shard of the
slot that first allocated it; ``pages_per_shard`` partitions the live pages
by home and sums to ``pages_in_use``. The engine passes its serve mesh's
data ranks (1 unsharded); the pool stays one global allocator, every rank
keeping the same copy, whichever rank holds a page's storage.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.paged_kv import GARBAGE_PAGE, KVPoolExhausted, PagedKVAllocator

__all__ = ["KVPagePool", "KVPoolExhausted", "prompt_prefix_hashes"]

_HASH_SEED = b"repro-paged-kv-v1"


def _host_array(x) -> np.ndarray:
    """A prompt leaf as a numpy array holding the leaf's own bytes. bf16 has
    no numpy dtype, so a bf16 tensor goes through its 2-byte patterns
    (``view(torch.int16)``) — the bytes the reference's ``ml_dtypes``
    bfloat16 arrays write."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    return np.asarray(x)


def prompt_prefix_hashes(batch: Dict[str, Any], page_tokens: int) -> Tuple[int, List[str]]:
    """Chained per-page content hashes of a batch-1 prompt, byte for byte
    the reference's.

    The fused prompt sequence is [frontend rows | tokens] (the decoder's
    early-fusion order); KV at position i depends only on positions ≤ i, so
    page j's content is named by a hash chained over positions 0 .. (j+1) ·
    page_tokens - 1. Extra batch leaves fold into the seed hash. Tokens hash
    as 8-byte little-endian integers whatever their dtype; frontend rows as
    their raw bytes. Returns ``(seq_len, hashes)`` with one hash per FULL
    page — the partial tail page is never shared and gets none."""
    tokens = _host_array(batch["tokens"])
    if tokens.ndim != 2 or tokens.shape[0] != 1:
        raise ValueError(
            f"prompt batches must have leading batch dim 1, got {tokens.shape}"
        )
    h = hashlib.sha1(_HASH_SEED)
    items: List[bytes] = []
    front = batch.get("frontend")
    if front is not None:
        for row in _host_array(front)[0]:
            items.append(np.ascontiguousarray(row).tobytes())
    for key in sorted(batch):
        if key not in ("tokens", "frontend"):
            h.update(key.encode())
            h.update(np.ascontiguousarray(_host_array(batch[key])).tobytes())
    for tok in tokens[0]:
        items.append(int(tok).to_bytes(8, "little", signed=True))
    seq_len = len(items)
    # the TOTAL length folds into the seed: prefill's attention reduction
    # shape depends on it, so only same-length prompts are guaranteed
    # bit-identical prefix KV
    h.update(seq_len.to_bytes(8, "little"))
    hashes: List[str] = []
    for j in range(seq_len // page_tokens):
        for it in items[j * page_tokens:(j + 1) * page_tokens]:
            h.update(it)
        hashes.append(h.hexdigest())
        h = h.copy()
    return seq_len, hashes


class KVPagePool:
    """Slot-indexed paged-KV bookkeeping over a ``PagedKVAllocator``."""

    def __init__(
        self,
        n_slots: int,
        max_seq: int,
        page_tokens: int,
        n_pages: int,
        page_bytes: float,
        n_data_shards: int = 1,
    ):
        if max_seq % page_tokens != 0:
            raise ValueError(
                f"max_seq ({max_seq}) must be divisible by page_tokens "
                f"({page_tokens}) so page tables cover the whole sequence"
            )
        if n_slots % n_data_shards != 0:
            raise ValueError(
                f"n_slots ({n_slots}) must divide over {n_data_shards} data shards"
            )
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.page_tokens = page_tokens
        self.max_pages = max_seq // page_tokens
        self.page_bytes = float(page_bytes)
        self.n_data_shards = n_data_shards
        self.alloc = PagedKVAllocator(n_pages, page_tokens)
        # host mirror of the device page table; row of GARBAGE_PAGE ⇔ free
        self.table = np.full((n_slots, self.max_pages), GARBAGE_PAGE, np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self._page_home: Dict[int, int] = {}
        # lifetime counters
        self.admitted = 0
        self.released = 0
        self.fresh_pages = 0      # pages allocated and written with new KV
        self.shared_pages_hit = 0  # prompt pages served by prefix sharing

    # -- geometry ------------------------------------------------------------
    def _shard_of(self, slot: int) -> int:
        return slot // (self.n_slots // self.n_data_shards)

    def slot_pages(self, slot: int) -> List[int]:
        return list(self._slot_pages[slot])

    # -- admission -----------------------------------------------------------
    def _shareable(self, seq_len: int, hashes: List[str]) -> List[str]:
        """Hashes of the pages this prompt may share. A prompt of exactly
        ``max_seq`` tokens fills its final page, but decode clamps the
        write position to ``max_seq - 1`` — inside that page — so sharing
        or content-registering it would let the clamped decode write
        mutate shared bytes and poison the prefix registry. The final page
        of a full-length prompt is therefore always private/anonymous."""
        if seq_len >= self.max_seq and len(hashes) * self.page_tokens >= seq_len:
            return hashes[:-1]
        return hashes

    def fresh_pages_needed(self, seq_len: int, hashes: List[str]) -> int:
        """How many pages an admission must newly allocate: prompt pages
        not already resident (live or cold) plus the private tail page."""
        hashes = self._shareable(seq_len, hashes)
        n_prompt_pages = -(-seq_len // self.page_tokens)
        fresh = n_prompt_pages - len(hashes)  # private tail/clamp pages
        for key in hashes:
            page = self.alloc._by_hash.get(key)
            if page is None:
                fresh += 1
        return fresh

    def can_admit(self, seq_len: int, hashes: List[str]) -> bool:
        """Whether an admission is guaranteed to succeed right now. Every
        non-live-shared page consumes exactly one unit of the free+cold
        reservoir: a fresh allocation pops a free page (or evicts a cold
        one), and a cold-prefix REVIVAL consumes its own cold entry — so
        revivable pages cannot double as supply for the fresh allocations
        (the bug the randomized pool property test pinned down)."""
        hashes = self._shareable(seq_len, hashes)
        fresh = 0
        cold_hits = 0
        for key in hashes:
            page = self.alloc._by_hash.get(key)
            if page is None:
                fresh += 1
            elif self.alloc.ref[page] == 0:
                cold_hits += 1
        n_prompt_pages = -(-seq_len // self.page_tokens)
        fresh += n_prompt_pages - len(hashes)  # private tail/clamp pages
        return fresh + cold_hits <= self.alloc.n_reclaimable

    def admit(self, slot: int, seq_len: int, hashes: List[str]) -> List[Tuple[int, bool]]:
        """Map a prompt's pages into ``slot``: full pages share by content
        when a live/cold twin exists, everything else allocates fresh.
        Returns ``[(page, is_fresh), ...]`` in position order — the engine
        writes prefill KV bytes only into the fresh ones. Any previous
        occupant of the slot is released first."""
        if self._slot_pages[slot]:
            self.release(slot)
        if seq_len > self.max_seq:
            raise ValueError(f"prompt of {seq_len} tokens exceeds max_seq {self.max_seq}")
        hashes = self._shareable(seq_len, hashes)
        n_prompt_pages = -(-seq_len // self.page_tokens)
        shard = self._shard_of(slot)
        entries: List[Tuple[int, bool]] = []
        try:
            for j in range(n_prompt_pages):
                if j < len(hashes):
                    page = self.alloc.lookup_prefix(hashes[j])
                    if page is not None:
                        entries.append((page, False))
                        self.shared_pages_hit += 1
                        continue
                    page = self.alloc.alloc()
                    self.alloc.register_prefix(page, hashes[j])
                else:  # tail page (partial, or clamp target): private
                    page = self.alloc.alloc()
                # unconditional: a page fresh off alloc() may be a recycled
                # cold eviction whose stale home would misattribute shards
                self._page_home[page] = shard
                self.fresh_pages += 1
                entries.append((page, True))
        except KVPoolExhausted:
            for page, is_fresh in entries:  # roll back the partial admission
                if is_fresh:
                    # a fresh page registered this admission holds no KV
                    # bytes yet (the engine writes prefill bytes only after
                    # admit returns) — forget its hash so release frees it
                    # instead of cold-retiring it, where a later same-prefix
                    # admission would revive unwritten content as real KV
                    self.alloc.forget_prefix(page)
                    self._page_home.pop(page, None)
                    self.fresh_pages -= 1
                self.alloc.release(page)
            raise
        self._slot_pages[slot] = [p for p, _ in entries]
        row = np.full(self.max_pages, GARBAGE_PAGE, np.int32)
        row[: len(entries)] = [p for p, _ in entries]
        self.table[slot] = row
        self.admitted += 1
        return entries

    # -- decode growth -------------------------------------------------------
    def pages_needed(self, slot: int, last_pos: int) -> int:
        """How many pages ``ensure(slot, last_pos)`` would allocate — a
        pure count, nothing is allocated. ``ensure`` never registers
        prefixes, so a batch of ensures is guaranteed to succeed iff the
        summed needs fit ``reclaimable_pages`` (the engine pre-checks a
        whole decode round this way and raises BEFORE mutating any table,
        so exhaustion is recoverable by preempting a slot)."""
        last_pos = min(last_pos, self.max_seq - 1)
        need = last_pos // self.page_tokens + 1
        return max(0, need - len(self._slot_pages[slot]))

    @property
    def reclaimable_pages(self) -> int:
        """Pages an allocation burst could obtain: free now + evictable cold."""
        return self.alloc.n_reclaimable

    def ensure(self, slot: int, last_pos: int) -> List[int]:
        """Grow ``slot``'s table to cover write positions up to
        ``last_pos`` (clamped to the sequence end — decode past max_seq
        overwrites the final position, matching the dense cache's clamp;
        the clamp target page is private by the sharing discipline).
        New pages are private and anonymous. Returns the pages added."""
        last_pos = min(last_pos, self.max_seq - 1)
        need = last_pos // self.page_tokens + 1
        have = len(self._slot_pages[slot])
        added: List[int] = []
        shard = self._shard_of(slot)
        for j in range(have, need):
            page = self.alloc.alloc()
            # unconditional (not setdefault): see admit
            self._page_home[page] = shard
            self._slot_pages[slot].append(page)
            self.table[slot, j] = page
            added.append(page)
        return added

    # -- release -------------------------------------------------------------
    def release(self, slot: int) -> int:
        """Drop every reference ``slot`` holds (eviction, preemption, drop
        rungs — all release paths funnel here). Shared prefix pages go cold
        once their last reference drops; private pages return to the free
        list. Returns the number of references released."""
        pages = self._slot_pages[slot]
        for page in pages:
            self.alloc.release(page)
        n = len(pages)
        self._slot_pages[slot] = []
        self.table[slot] = GARBAGE_PAGE
        if n:
            self.released += 1
        # forget homes of pages that fully left circulation (free list);
        # cold pages keep their home until evicted or re-allocated
        for page in pages:
            if self.alloc.refcount(page) == 0 and page not in self.alloc._cold:
                self._page_home.pop(page, None)
        return n

    # -- accounting ----------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        return self.alloc.n_live

    @property
    def shared_pages(self) -> int:
        return int((self.alloc.ref[GARBAGE_PAGE + 1:] > 1).sum())

    @property
    def kv_bytes_in_use(self) -> float:
        return self.pages_in_use * self.page_bytes

    @property
    def capacity_bytes(self) -> float:
        return self.alloc.n_pages * self.page_bytes

    def pages_per_shard(self, n_shards: Optional[int] = None) -> List[int]:
        """Live pages partitioned by home data shard — sums exactly to
        ``pages_in_use`` (pages shard over ``data`` with the slot rows that
        own them; a shared page counts once, at its first owner's home)."""
        n = self.n_data_shards if n_shards is None else n_shards
        out = [0] * n
        for page in range(GARBAGE_PAGE + 1, self.alloc.n_pages):
            if self.alloc.ref[page] > 0:
                out[self._page_home.get(page, 0) % n] += 1
        return out

    def steady_state(self) -> bool:
        """True when no slot holds any page (everything free or cold) —
        the post-drain invariant the cross-feature regression pins."""
        return self.pages_in_use == 0 and not any(self._slot_pages)

    def check(self) -> None:
        """Allocator conservation + table/refcount cross-invariants: every
        live page's refcount equals the number of slot-table references it
        has, and no page is reachable from two slots unless shared."""
        self.alloc.check()
        counts = np.zeros(self.alloc.n_pages, np.int64)
        for slot in range(self.n_slots):
            pages = self._slot_pages[slot]
            assert len(set(pages)) == len(pages), f"slot {slot} references a page twice"
            for j, page in enumerate(pages):
                assert self.table[slot, j] == page, "table mirror out of sync"
                counts[page] += 1
            assert (self.table[slot, len(pages):] == GARBAGE_PAGE).all(), (
                f"slot {slot} table tail not garbage-mapped"
            )
        counts[GARBAGE_PAGE] = 1  # permanent reservation
        live = self.alloc.ref
        assert (counts == live).all(), (
            f"table references != refcounts at pages "
            f"{np.where(counts != live)[0].tolist()}"
        )

    def summary(self) -> Dict[str, Any]:
        s = self.alloc.summary()
        s.update(
            pages_in_use=self.pages_in_use,
            kv_bytes_in_use=self.kv_bytes_in_use,
            capacity_bytes=self.capacity_bytes,
            admitted=self.admitted,
            released=self.released,
            fresh_pages=self.fresh_pages,
            shared_pages_hit=self.shared_pages_hit,
        )
        return s
