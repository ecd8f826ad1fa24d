"""Serving-side KV cache management (host side, numpy; port of
:mod:`repro.serve.kvcache`): slot + paged block-table allocators.

The engine keeps a fixed pool of ``max_batch`` slots it schedules against.
Two allocators back those slots:

``SlotAllocator`` (contiguous)
    Each slot owns a full ``max_len`` stride of the stacked
    (layers, batch, max_len, kv_heads, head_dim) cache buffers — memory for
    the worst case is reserved up front whether or not a request uses it.
    Kept as the baseline arm of the paged allocator.

``PagedAllocator`` (block tables)
    KV rows live in a shared pool of fixed-size pages
    (layers, num_pages, page_size, kv_heads, head_dim).  Each slot holds a
    block table mapping logical page index -> physical page; pages are
    handed out from a free list on demand as a request's cursor grows and
    reclaimed in O(pages-held) when the slot is released (free-list push,
    no compaction, no copying).  ``high_water_pages`` records the peak
    pool occupancy, to compare against the contiguous baseline's
    always-fully-reserved buffer.

    Physical page 0 is reserved as the *trash page*: inactive batch rows
    still flow through the batched decode step (static shapes), and their
    garbage KV writes must land somewhere that no live slot owns.  Block
    tables are zeroed on release, so stale rows scatter into page 0, which
    is never allocated and never read (validity is cursor-defined).

    Pages are **reference counted** (DESIGN.md §11): the shared-prefix
    radix index (`serve.prefix.PrefixIndex`) and any number of slots may
    reference the same physical page.  ``map_shared`` points a slot's
    block table at already-populated pages (refcount++), ``release``
    decrements instead of freeing, and a page returns to the free list
    only when its count hits zero.  A slot may write into a mapped page
    only while it is the sole owner (``writable``); ``fork`` implements
    the copy-on-write half — a fresh page replaces the shared one in the
    slot's table and the *caller* copies the device pool rows.  When the
    free list runs dry, an attached reclaimer (the prefix index's LRU
    eviction) is asked to give pages back before allocation fails.

Both allocators expose the same scheduling surface (``claim`` /
``release`` / ``active`` / ``lengths`` / ``slots``); the paged one adds
``ensure(slot, length)`` for on-demand page growth and a ``block_tables``
array the engine mirrors into device state.

The host-side ``block_tables`` here is the single source of truth: the
engine pushes it to the device in batched whole-array uploads (at most
one per decode tick and one per prefill chunk batch), and
the device side broadcasts that one mirror across the layer axis, which
is what makes the whole-model fused page gather in the decode step sound
(DESIGN.md §14).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SlotState:
    request_id: Optional[int] = None
    length: int = 0
    done: bool = True


class SlotAllocator:
    """Contiguous allocator: slot i owns rows [i] of the cache buffers."""

    def __init__(self, max_batch: int):
        self.slots: List[SlotState] = [SlotState() for _ in range(max_batch)]

    def claim(self, request_id: int) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s.done:
                self.slots[i] = SlotState(request_id, 0, False)
                return i
        return None

    def release(self, slot: int):
        self.slots[slot] = SlotState()

    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.done]

    def lengths(self) -> np.ndarray:
        return np.array([s.length for s in self.slots], np.int32)


class PagedAllocator:
    """Block-table allocator over a shared, ref-counted page pool
    (vLLM-style).

    ``num_pages`` counts *physical* pages including the reserved trash
    page 0; usable capacity is ``num_pages - 1``.  The default sizing
    (``max_batch * pages_per_slot + 1``) can always hold every slot at
    ``max_len`` — undersize it to serve more slots than worst-case memory,
    at the cost of admission backpressure when the free list runs dry.
    """

    def __init__(self, max_batch: int, max_len: int, page_size: int = 16,
                 num_pages: Optional[int] = None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.max_len = max_len
        self.pages_per_slot = -(-max_len // page_size)
        if num_pages is None:
            num_pages = max_batch * self.pages_per_slot + 1
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        self.num_pages = num_pages
        self.slots: List[SlotState] = [SlotState() for _ in range(max_batch)]
        self.block_tables = np.zeros((max_batch, self.pages_per_slot),
                                     np.int32)
        self._pages: List[List[int]] = [[] for _ in range(max_batch)]
        # LIFO free list (page 0 reserved as the trash page): pop from the
        # end so recently-released pages are reused while still cache-warm
        self.free: List[int] = list(range(num_pages - 1, 0, -1))
        # per-physical-page reference count: slots and the prefix index
        # each hold one reference per mapping (page 0 never counted)
        self.ref = np.zeros(num_pages, np.int32)
        self.high_water_pages = 0
        self._reclaim: Optional[Callable[[int], int]] = None

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self.free)

    def attach_reclaimer(self, fn: Callable[[int], int]):
        """``fn(n)`` is asked to return >= ``n`` pages to the free list
        (by dropping its own references) when allocation runs dry — the
        prefix index's LRU eviction.  Best effort: it returns how many
        pages it actually freed."""
        self._reclaim = fn

    # ---- reference counting ----
    def addref(self, page: int):
        if page == 0:
            raise ValueError("page 0 is the reserved trash page")
        self.ref[page] += 1

    def decref(self, page: int) -> int:
        """Drop one reference; returns 1 if the page went back to the
        free list, 0 if other references keep it alive."""
        if self.ref[page] <= 0:
            raise RuntimeError(
                f"page {page} double-freed (refcount already 0)")
        self.ref[page] -= 1
        if self.ref[page] == 0:
            self.free.append(page)
            return 1
        return 0

    def _alloc_page(self, still_needed: int) -> Optional[int]:
        """Pop a fresh page (refcount 1), asking the reclaimer to evict
        cached pages when the free list is dry.  ``still_needed`` is a
        hint for how many more pages the current operation wants."""
        if not self.free and self._reclaim is not None:
            self._reclaim(max(still_needed, 1))
        if not self.free:
            return None
        page = self.free.pop()
        self.ref[page] = 1
        return page

    # ---- slot lifecycle ----
    def claim(self, request_id: int) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s.done:
                self.slots[i] = SlotState(request_id, 0, False)
                return i
        return None

    def held(self, slot: int) -> List[int]:
        """Physical pages mapped by ``slot`` in logical order."""
        return list(self._pages[slot])

    def map_shared(self, slot: int, pages: List[int]):
        """Point the slot's leading block-table entries at already-
        populated shared pages (prefix-cache hit): refcount++ each, no
        free-list traffic.  Must be called on a freshly claimed slot,
        before any ``ensure`` growth."""
        if self._pages[slot]:
            raise RuntimeError(
                f"map_shared on slot {slot} with {len(self._pages[slot])} "
                f"pages already mapped — shared prefixes mount at logical 0")
        if len(pages) > self.pages_per_slot:
            raise ValueError("shared prefix exceeds the per-slot table")
        for i, page in enumerate(pages):
            self.addref(page)
            self.block_tables[slot, i] = page
            self._pages[slot].append(page)

    def ensure(self, slot: int, length: int) -> Optional[bool]:
        """Grow ``slot``'s block table to cover ``length`` positions.

        Returns True if new pages were mapped, False if already covered,
        None if the free list ran dry — even after asking the reclaimer
        to evict (caller backpressures: requeue the request or hard-stop
        the generation).  Pages grabbed before an exhaustion are kept
        mapped — they are reclaimed with the slot.
        """
        need = -(-length // self.page_size)
        if need > self.pages_per_slot:
            return None
        grew = False
        held = self._pages[slot]
        while len(held) < need:
            page = self._alloc_page(need - len(held))
            if page is None:
                return None
            self.block_tables[slot, len(held)] = page
            held.append(page)
            grew = True
            # inside the loop so a partial growth that then runs dry still
            # counts toward the peak (those pages stay mapped)
            self.high_water_pages = max(self.high_water_pages,
                                        self.pages_in_use)
        return grew

    # ---- copy-on-write ----
    def writable(self, slot: int, logical: int) -> bool:
        """True when the slot is the sole owner of its ``logical``-th
        page — i.e. scattering KV rows into it cannot corrupt another
        slot's view or the prefix index's cached content."""
        return int(self.ref[self._pages[slot][logical]]) == 1

    def fork(self, slot: int, logical: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write fork: replace the shared ``logical``-th page of
        ``slot`` with a fresh page (refcount 1) and drop the slot's
        reference on the shared one.  Returns ``(old, new)`` physical ids
        so the caller can copy the device pool rows (the allocator only
        does the accounting), or None if no page could be allocated."""
        old = self._pages[slot][logical]
        new = self._alloc_page(1)
        if new is None:
            return None
        self.decref(old)            # shared owners keep it alive
        self._pages[slot][logical] = new
        self.block_tables[slot, logical] = new
        self.high_water_pages = max(self.high_water_pages, self.pages_in_use)
        return old, new

    def release(self, slot: int):
        # O(pages-held) reclaim: drop one reference per mapped page (the
        # free-list push happens at refcount 0), zero the table
        for page in self._pages[slot]:
            self.decref(page)
        self._pages[slot] = []
        self.block_tables[slot] = 0
        self.slots[slot] = SlotState()

    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.done]

    def lengths(self) -> np.ndarray:
        return np.array([s.length for s in self.slots], np.int32)
