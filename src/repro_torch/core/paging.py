"""Paged KV-cache accounting: a refcounted free-list over fixed-size pages.

Copy of ``repro.core.paging`` (numpy only), held to it by
``tests/test_torch_decode.py``.

The decode step loop keeps every resident request's KV state in ONE
shared pool of fixed-size pages instead of a per-request contiguous cache, so
requests of wildly different lengths can share a batch slot-for-slot without
padding each row to the longest. This module is the *accounting* half of that
tier — it owns which page belongs to whom; the device arrays (``k_pages`` /
``v_pages`` in :meth:`repro_torch.models.model.Model.decode_paged`) are written by
the step program through the page table this pool materialises.

Design mirrors the ``ChunkStore`` of ``repro.core.blobstore``: pages are
refcounted (``fork`` shares a prefix the way two snapshots share a chunk),
freed only at refcount zero, and every mutation is atomic under one lock.

Invariants:

* Page 0 is the reserved NULL page: never allocated, never freed. Unused
  page-table slots point at it, so an empty batch row's reads and writes land
  there harmlessly instead of aliasing a live request's pages.
* ``alloc_chain`` is all-or-nothing: on exhaustion it returns ``None`` and
  the pool is byte-for-byte unchanged — admission control can retry the same
  request later and observe the exact same answer for the exact same pool
  state (deterministic admit-or-queue, never a half-built chain).
* ``release`` decrements each page's refcount and frees at zero; releasing a
  chain twice is a no-op (the chain marks itself dead), so an EOS racing a
  deadline cancel cannot double-free a page into two future owners.
* A live page is owned by exactly the chains whose refcount entry includes
  it: no page is ever handed to a new chain while any live chain still
  references it (the no-aliasing invariant the property tests pin).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

NULL_PAGE = 0


class PageChain:
    """One request's ordered list of pages plus its token-capacity bookkeeping.

    ``pages`` is ordered by position: token ``t`` lives at
    ``(pages[t // page_size], t % page_size)``. ``capacity`` is
    ``len(pages) * page_size`` — the reservation made at admission covers the
    prompt plus the worst-case decode budget, so the step loop never has to
    grow a chain mid-flight (growth exists for callers that reserve lazily).
    """

    __slots__ = ("pages", "page_size", "released")

    def __init__(self, pages: List[int], page_size: int) -> None:
        self.pages = pages
        self.page_size = page_size
        self.released = False

    @property
    def capacity(self) -> int:
        return len(self.pages) * self.page_size

    def table_row(self, max_pages: int) -> np.ndarray:
        """This chain's page-table row, padded with the null page."""
        row = np.full((max_pages,), NULL_PAGE, dtype=np.int32)
        n = min(len(self.pages), max_pages)
        row[:n] = self.pages[:n]
        return row


class PagePool:
    """Fixed pool of ``n_pages`` KV pages with a refcounted free list.

    ``n_pages`` counts the whole device pool INCLUDING the reserved null
    page, so it matches the leading axis of the ``k_pages``/``v_pages``
    arrays; ``n_pages - 1`` pages are actually allocatable. A "page" here is
    one logical page across every layer of the model (the device arrays carry
    the layer axis), so the allocator accounts it once.
    """

    def __init__(self, n_pages: int, page_size: int) -> None:
        if n_pages < 2:
            raise ValueError("need at least one allocatable page beyond null")
        if page_size < 1:
            raise ValueError("page_size must be positive")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        # LIFO free list: recently-freed pages are re-used first, which keeps
        # the working set of device pages dense
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self.allocs = 0
        self.alloc_failures = 0
        self.frees = 0
        self.high_water = 0            # max pages simultaneously live

    # ------------------------------------------------------------------ sizes
    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` (at least one: a chain always
        owns the page its next token will be written to)."""
        return max(1, -(-int(n_tokens) // self.page_size))

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self) -> int:
        with self._lock:
            return len(self._refs)

    # -------------------------------------------------------------------- api
    def alloc_chain(self, n_tokens: int) -> Optional[PageChain]:
        """Reserve pages for ``n_tokens`` — all of them or none of them.

        Returns ``None`` when the free list cannot cover the request, leaving
        the pool untouched (the caller queues the request; re-asking with an
        unchanged pool gives the same answer).
        """
        need = self.pages_for(n_tokens)
        with self._lock:
            if need > len(self._free):
                self.alloc_failures += 1
                return None
            pages = [self._free.pop() for _ in range(need)]
            for p in pages:
                self._refs[p] = 1
            self.allocs += need
            self.high_water = max(self.high_water, len(self._refs))
            return PageChain(pages, self.page_size)

    def extend(self, chain: PageChain, n_tokens: int) -> bool:
        """Grow ``chain`` to hold ``n_tokens``; True iff it now fits.

        Growth within the existing reservation is free. Beyond it, pages are
        appended one refcount-1 page at a time — but all-or-nothing like
        ``alloc_chain``: if the free list cannot cover the growth, nothing is
        taken and the resident chain is exactly as it was.
        """
        if chain.released:
            raise ValueError("extend on a released chain")
        need = self.pages_for(n_tokens) - len(chain.pages)
        if need <= 0:
            return True
        with self._lock:
            if need > len(self._free):
                self.alloc_failures += 1
                return False
            grown = [self._free.pop() for _ in range(need)]
            for p in grown:
                self._refs[p] = 1
            chain.pages.extend(grown)
            self.allocs += need
            self.high_water = max(self.high_water, len(self._refs))
            return True

    def fork(self, chain: PageChain) -> PageChain:
        """Share ``chain``'s pages into a second chain (prefix sharing).

        Both chains reference the same pages — the blobstore move: bytes are
        stored once, freed when the LAST referent releases. Callers that then
        diverge must ``extend`` the fork before writing past its capacity.
        """
        if chain.released:
            raise ValueError("fork of a released chain")
        with self._lock:
            for p in chain.pages:
                self._refs[p] += 1
            return PageChain(list(chain.pages), self.page_size)

    def release(self, chain: PageChain) -> int:
        """Drop a chain's references; returns how many pages were freed.

        Pages still shared with a live fork stay resident. Releasing the same
        chain again is a no-op, so EOS and a racing deadline cancel can both
        call this safely.
        """
        if chain.released:
            return 0
        chain.released = True
        freed = 0
        with self._lock:
            for p in chain.pages:
                n = self._refs.get(p, 0) - 1
                if n > 0:
                    self._refs[p] = n
                else:
                    self._refs.pop(p, None)
                    self._free.append(p)
                    freed += 1
            self.frees += freed
        return freed

    # --------------------------------------------------------------- reports
    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refs.get(page, 0)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "n_pages": float(self.n_pages),
                "page_size": float(self.page_size),
                "free_pages": float(len(self._free)),
                "used_pages": float(len(self._refs)),
                "high_water": float(self.high_water),
                "allocs": float(self.allocs),
                "alloc_failures": float(self.alloc_failures),
                "frees": float(self.frees),
            }
