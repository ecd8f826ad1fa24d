"""Shared-prefix radix KV cache (port of :mod:`repro.serve.prefix`): a
page-granular trie over finished token sequences (DESIGN.md §11).

Real serving traffic is dominated by requests that share long prompt
prefixes (system prompts, few-shot templates, multi-turn history), and
every prefill token re-computed under encryption is PBS-priced — so the
engine keeps the KV pages of finished requests alive in a radix index and
lets later admissions *mount* the longest matching page run instead of
re-prefilling it.

Granularity is the page: a KV page holds exactly ``page_size`` token
rows, so only **page-aligned** prefixes are shareable, and the trie's
alphabet is the page — each edge is labelled with a run of page-sized
token tuples and carries the physical pages backing them.  Two sequences
that diverge *inside* a page share nothing (their page tuples differ),
which is exactly the safe choice: a partially-matching page would hold
rows the new request must overwrite.

Ownership: the index holds **one allocator reference per cached page**
(`PagedAllocator.addref`).  ``insert`` takes references only on the pages
of newly created edges (re-walked prefixes keep their original pages);
``evict`` drops references LRU-leaf-first until enough pages actually
return to the free list — a leaf whose pages are still mounted by an
active slot is detached from the trie but its pages survive on the
slot's references.  Matching never blocks eviction, so the cache can
never cause an admission failure that an empty cache would not
(``PagedAllocator.attach_reclaimer`` wires ``evict`` in as the
free-list-dry fallback).
"""

from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.kvcache import PagedAllocator

PageKey = Tuple[int, ...]


class _Node:
    """One radix edge: ``keys[i]`` (a page-sized token tuple) is backed by
    physical page ``phys[i]``.  Children are keyed by the first page tuple
    of their edge."""

    __slots__ = ("keys", "phys", "children", "parent", "stamp")

    def __init__(self, keys: List[PageKey], phys: List[int],
                 parent: Optional["_Node"], stamp: int = 0):
        self.keys = keys
        self.phys = phys
        self.children: Dict[PageKey, "_Node"] = {}
        self.parent = parent
        self.stamp = stamp


class PrefixIndex:
    """Radix index mapping token-sequence prefixes to physical page runs.

    All operations are host-side and O(sequence length); device pool
    contents are never touched here (pages are immutable while cached —
    the engine forks before any write, DESIGN.md §11).
    """

    def __init__(self, alloc: PagedAllocator):
        self.alloc = alloc
        self.page_size = alloc.page_size
        self.root = _Node([], [], None)
        self._clock = 0
        # counters surfaced through Engine.stats()
        self.evictions = 0          # pages dropped from the index
        self.hits = 0               # match() calls returning > 0 tokens
        self.misses = 0

    # ---- helpers ----
    def _page_keys(self, tokens: Sequence[int]) -> List[PageKey]:
        """Full page-sized token tuples covering the aligned prefix."""
        ps = self.page_size
        toks = np.asarray(tokens)
        n = (len(toks) // ps) * ps
        return [tuple(int(t) for t in toks[i:i + ps])
                for i in range(0, n, ps)]

    @property
    def cached_pages(self) -> int:
        total, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            total += len(node.phys)
            stack.extend(node.children.values())
        return total

    # ---- lookup ----
    def match(self, tokens: Sequence[int], *,
              touch: bool = True) -> Tuple[int, List[int]]:
        """Longest page-aligned cached prefix of ``tokens``.

        Returns ``(n_tokens, pages)`` with ``n_tokens`` a multiple of
        ``page_size`` and ``pages`` the physical pages holding those KV
        rows *in logical order*.  ``touch`` refreshes the LRU stamp of
        every node on the path (scheduler affinity probes pass
        ``touch=False`` so peeking does not distort eviction order).
        """
        keys = self._page_keys(tokens)
        if touch:
            self._clock += 1
        node, i, pages = self.root, 0, []
        while i < len(keys):
            child = node.children.get(keys[i])
            if child is None:
                break
            m = 0
            while (m < len(child.keys) and i + m < len(keys)
                   and child.keys[m] == keys[i + m]):
                m += 1
            pages.extend(child.phys[:m])
            if touch:
                child.stamp = self._clock
            i += m
            if m < len(child.keys):
                break               # diverged inside the edge
            node = child
        if touch:
            if pages:
                self.hits += 1
            else:
                self.misses += 1
        return len(pages) * self.page_size, pages

    # ---- insertion ----
    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Cache the page-aligned prefix of ``tokens`` backed by
        ``pages`` (physical, logical order — a finished slot's block
        run).  Only the suffix past the already-cached prefix creates
        edges, and only those pages gain an index reference; re-walked
        prefixes keep their original physical pages (the duplicates the
        finished slot held are freed with the slot).  Returns the number
        of pages newly referenced."""
        keys = self._page_keys(tokens)
        if len(pages) < len(keys):
            raise ValueError(
                f"{len(keys)} page keys but only {len(pages)} pages")
        self._clock += 1
        node, i = self.root, 0
        while i < len(keys):
            child = node.children.get(keys[i])
            if child is None:
                # new edge: take a reference on each backing page
                new_phys = [int(p) for p in pages[i:len(keys)]]
                for p in new_phys:
                    self.alloc.addref(p)
                node.children[keys[i]] = _Node(keys[i:], new_phys, node,
                                               self._clock)
                return len(new_phys)
            m = 0
            while (m < len(child.keys) and i + m < len(keys)
                   and child.keys[m] == keys[i + m]):
                m += 1
            child.stamp = self._clock
            if m < len(child.keys):
                # diverged mid-edge: split at the page-aligned boundary m
                # (m >= 1: the child was found by its first page tuple)
                mid = _Node(child.keys[:m], child.phys[:m], node,
                            self._clock)
                tail_key = child.keys[m]
                child.keys = child.keys[m:]
                child.phys = child.phys[m:]
                child.parent = mid
                mid.children[tail_key] = child
                node.children[keys[i]] = mid
                node, i = mid, i + m
            else:
                node, i = child, i + m
        return 0

    # ---- eviction ----
    def evict(self, need_pages: int) -> int:
        """Drop least-recently-used leaves until ``need_pages`` pages have
        actually returned to the free list (or nothing evictable
        remains).  Eviction is edge-at-a-time (a leaf's whole page run),
        leaf-first so interior prefixes shared by surviving entries stay
        cached; detaching a leaf can expose its parent as the next LRU
        candidate (pushed onto the same stamp-ordered heap — one trie
        walk per call, not per victim).  Returns the number of pages
        freed."""
        freed = 0
        tie = itertools.count()            # heap tiebreak (nodes unordered)
        heap = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.children:
                    stack.append(child)
                else:
                    heapq.heappush(heap, (child.stamp, next(tie), child))
        while freed < need_pages and heap:
            _, _, victim = heapq.heappop(heap)
            for p in victim.phys:
                freed += self.alloc.decref(p)
            self.evictions += len(victim.phys)
            parent = victim.parent
            parent.children.pop(victim.keys[0])
            victim.parent = None
            if parent is not self.root and not parent.children:
                heapq.heappush(heap, (parent.stamp, next(tie), parent))
        return freed

    def clear(self) -> int:
        """Drop every cached entry (all index references)."""
        return self.evict(self.cached_pages + 1)
