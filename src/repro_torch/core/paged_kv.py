"""Paged-KV page allocator: free list, refcounts, copy-on-write, prefix
cache (the port's copy of ``repro.core.paged_kv``; plain Python and numpy,
no tensors).

The serve stack's paged KV cache is a fixed pool of ``page_tokens``-token
pages, per-slot page tables mapping logical positions to physical pages,
refcounted sharing of common prompt prefixes, and copy-on-write for forks.
This module is the allocator alone, so its invariants can be tested
without a model (``tests/test_torch_paged_kv.py``);
``serving/kv_pool.py`` wraps it per slot and ``models/attention.py``
moves the KV bytes through the tables.

Page lifecycle::

    free ──alloc──▶ live (ref ≥ 1) ──release to ref 0──▶
        • registered prefix page → cold (content-addressed, evictable)
        • anonymous page         → free

    cold ──lookup_prefix hit──▶ live (revived, ref 1)
    cold ──evict_cold──▶ free        (never touches ref > 0 pages)

Conservation (``check()``): live + cold + free == capacity at every step,
refcounts never go negative, and a page is reachable from two owners only
while its refcount covers both.

Page 0 is reserved as the garbage page: free table rows point at it, so
decode writes from unoccupied slots land where no live table reads. It is
born with a permanent self-reference and is excluded from capacity.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

GARBAGE_PAGE = 0


class KVPoolExhausted(RuntimeError):
    """No free page available (and the caller chose not to evict)."""


class PagedKVAllocator:
    """Refcounted free-list allocator over ``n_pages`` physical pages.

    ``n_pages`` counts the whole pool INCLUDING the reserved garbage page
    0; ``capacity`` (= n_pages - 1) pages are allocatable."""

    def __init__(self, n_pages: int, page_tokens: int):
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is reserved), got {n_pages}")
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        self.n_pages = int(n_pages)
        self.page_tokens = int(page_tokens)
        self.ref = np.zeros(self.n_pages, np.int64)
        self.ref[GARBAGE_PAGE] = 1  # permanent — never allocated, never freed
        # LIFO free list: reuse recently-freed pages first (cache-friendlier)
        self._free: List[int] = list(range(self.n_pages - 1, GARBAGE_PAGE, -1))
        # content-addressed prefix pages: hash -> page while live or cold;
        # cold pages (ref 0, evictable) additionally sit in _cold in LRU order
        self._by_hash: Dict[str, int] = {}
        self._hash_of: Dict[int, str] = {}
        self._cold: "OrderedDict[int, None]" = OrderedDict()
        # lifetime counters (monotone; the pool surfaces them)
        self.shared_hits = 0   # lookup_prefix hits (live or revived cold)
        self.cow_copies = 0    # prepare_write copies triggered by ref > 1
        self.evictions = 0     # cold pages reclaimed to the free list

    # -- capacity ------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.n_pages - 1  # page 0 excluded

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_cold(self) -> int:
        return len(self._cold)

    @property
    def n_live(self) -> int:
        """Pages with at least one reference (garbage page excluded)."""
        return int((self.ref[GARBAGE_PAGE + 1:] > 0).sum())

    @property
    def n_reclaimable(self) -> int:
        """Pages an allocation burst could obtain: free now + evictable cold."""
        return self.n_free + self.n_cold

    def refcount(self, page: int) -> int:
        return int(self.ref[page])

    # -- alloc / share / release ---------------------------------------------
    def alloc(self) -> int:
        """Take one page off the free list (evicting a cold page if the
        list is empty), ref = 1. Raises KVPoolExhausted when nothing is
        free nor evictable."""
        if not self._free and not self.evict_cold(1):
            raise KVPoolExhausted(
                f"KV page pool exhausted: {self.n_live}/{self.capacity} pages "
                "live, none free or cold-evictable"
            )
        page = self._free.pop()
        assert self.ref[page] == 0
        self.ref[page] = 1
        return page

    def retain(self, page: int) -> int:
        """Add one reference to a live page (prefix sharing / fork)."""
        if page == GARBAGE_PAGE:
            raise ValueError("cannot retain the reserved garbage page")
        if self.ref[page] <= 0:
            raise ValueError(f"retain on non-live page {page} (ref {self.ref[page]})")
        self.ref[page] += 1
        return page

    def release(self, page: int) -> None:
        """Drop one reference. At ref 0 a registered prefix page goes cold
        (content kept, evictable); an anonymous page returns to the free
        list. Releasing an already-free page is a double free and raises."""
        if page == GARBAGE_PAGE:
            raise ValueError("cannot release the reserved garbage page")
        if self.ref[page] <= 0:
            raise ValueError(f"double free of page {page}")
        self.ref[page] -= 1
        if self.ref[page] == 0:
            if page in self._hash_of:
                self._cold[page] = None  # most-recently-cold at the end
                self._cold.move_to_end(page)
            else:
                self._free.append(page)

    # -- prefix sharing ------------------------------------------------------
    def register_prefix(self, page: int, key: str) -> None:
        """Content-address a live page by its token-prefix hash so later
        admissions with the same prefix can share it."""
        if self.ref[page] <= 0:
            raise ValueError(f"register_prefix on non-live page {page}")
        old = self._by_hash.get(key)
        if old is not None and old != page:
            # same content stored twice (raced admissions): keep the newer
            # mapping; the old page loses its cold-revival path, and if it
            # was already cold it has nothing left to offer — free it
            self._forget_hash(old)
            if self.ref[old] == 0 and old in self._cold:
                del self._cold[old]
                self._free.append(old)
        # re-registering a page under a new key drops the old mapping, or a
        # stale _by_hash entry could later revive a page whose content the
        # new key owns
        self._forget_hash(page)
        self._by_hash[key] = page
        self._hash_of[page] = key

    def lookup_prefix(self, key: str) -> Optional[int]:
        """Find a page holding this prefix. Live hit → retain; cold hit →
        revive with ref 1. Returns the page or None."""
        page = self._by_hash.get(key)
        if page is None:
            return None
        if self.ref[page] > 0:
            self.retain(page)
        else:  # revive from cold
            del self._cold[page]
            self.ref[page] = 1
        self.shared_hits += 1
        return page

    def forget_prefix(self, page: int) -> None:
        """Drop a live page's content-addressing before its bytes were ever
        written (e.g. rolling back a failed admission): on release it then
        returns to the free list instead of cold-retiring, so it can never
        be revived as prefix content it does not actually hold."""
        if self.ref[page] <= 0:
            raise ValueError(f"forget_prefix on non-live page {page}")
        self._forget_hash(page)

    def _forget_hash(self, page: int) -> None:
        key = self._hash_of.pop(page, None)
        if key is not None and self._by_hash.get(key) == page:
            del self._by_hash[key]

    def evict_cold(self, n: int = 1) -> int:
        """Reclaim up to ``n`` least-recently-cold pages to the free list.
        Never touches a page with live references (cold ⇔ ref 0 by
        construction). Returns how many were evicted."""
        done = 0
        while done < n and self._cold:
            page, _ = self._cold.popitem(last=False)  # LRU end
            assert self.ref[page] == 0
            self._forget_hash(page)
            self._free.append(page)
            self.evictions += 1
            done += 1
        return done

    # -- copy-on-write -------------------------------------------------------
    def fork(self, pages: List[int]) -> List[int]:
        """Fork a page-table row: every page gains a reference; both owners
        now see the same physical pages until one writes (COW)."""
        return [self.retain(p) for p in pages]

    def prepare_write(self, page: int) -> Tuple[int, Optional[int]]:
        """COW write barrier: writing a page with ref > 1 (or a registered
        prefix page — shared content must stay immutable for future
        admissions) first materializes a private copy. Returns
        ``(page_to_write, copy_src)`` — ``copy_src`` is None when the page
        was already private, else the page whose bytes the caller must copy
        into the returned fresh page before writing."""
        if self.ref[page] <= 0:
            raise ValueError(f"prepare_write on non-live page {page}")
        if self.ref[page] == 1 and page not in self._hash_of:
            return page, None
        fresh = self.alloc()
        self.release(page)
        self.cow_copies += 1
        return fresh, page

    # -- invariants ----------------------------------------------------------
    def check(self) -> None:
        """Assert the conservation invariants; raises AssertionError with a
        diagnostic on any violation. O(n_pages)."""
        assert self.ref[GARBAGE_PAGE] == 1, "garbage page lost its reservation"
        assert (self.ref >= 0).all(), f"negative refcount: {np.where(self.ref < 0)[0]}"
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "duplicate page on the free list"
        assert GARBAGE_PAGE not in free_set, "garbage page leaked onto the free list"
        cold_set = set(self._cold)
        assert not (free_set & cold_set), "page both free and cold"
        for p in free_set | cold_set:
            assert self.ref[p] == 0, f"page {p} on free/cold list with ref {self.ref[p]}"
        for p in cold_set:
            assert p in self._hash_of, f"cold page {p} has no prefix hash"
        live = self.n_live
        assert live + self.n_cold + self.n_free == self.capacity, (
            f"page conservation violated: live {live} + cold {self.n_cold} "
            f"+ free {self.n_free} != capacity {self.capacity}"
        )

    def summary(self) -> Dict[str, int]:
        return {
            "capacity": self.capacity,
            "live": self.n_live,
            "cold": self.n_cold,
            "free": self.n_free,
            "shared": int((self.ref[GARBAGE_PAGE + 1:] > 1).sum()),
            "shared_hits": self.shared_hits,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
        }
