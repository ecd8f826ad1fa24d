"""Batched serving engine with continuous batching.

Port of :mod:`repro.serve.engine`, run eagerly in PyTorch:

  * A fixed pool of ``max_batch`` slots backs one layer-stacked KV cache
    with per-slot cursors.  The cache is **paged** by default: KV rows
    live in a shared page pool behind per-slot block tables
    (``serve.kvcache.PagedAllocator``); ``allocator="contiguous"`` keeps
    dense per-slot buffers as the baseline arm.
  * Admitted prompts are prefilled as a single row in chunks of
    ``prefill_chunk`` tokens; the final partial chunk is padded to a
    power-of-two bucket and, near ``max_len``, left-shifted over
    already-written positions (idempotent rewrites).
  * With ``tick_budget`` set, prefill chunks are interleaved with decode
    ticks under the scheduler's token budget; a partially prefilled
    admission is engine state (``Engine.admitting``, ``_PartialPrefill``).
  * Every tick runs one decode step for all slots together.  Inactive
    rows compute garbage that is ignored; under paging their writes land
    on the trash page 0.  On CUDA the decode step's attention runs the
    paged decode kernels (``kernels.paged``), one launch per layer per
    tick; prefill chunks take the gather path.
  * Finished requests feed a shared-prefix radix index
    (``serve.prefix.PrefixIndex``); admission mounts the longest cached
    page-aligned prefix and pages are copy-on-write (an in-place page
    copy on the device).
  * Host block tables are authoritative; the device mirror is refreshed
    in one batched upload per tick when dirty.

Compared with the reference: there is no jit, so ``prefill_compiles`` /
``decode_compiles`` report the distinct step shapes seen; the proven
retrace budget, warmup and the span tracer are later work
(``Engine.tel`` is always None).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.attention import KVCache, PagedKVCache
from repro_torch.device import resolve_device
from repro_torch.models.registry import ModelApi
from repro_torch.models.transformer import LayerState
from repro_torch.serve.kvcache import PagedAllocator, SlotAllocator
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.scheduler import make_scheduler
from repro_torch.serve.telemetry import MetricsRegistry

log = logging.getLogger("repro_torch.serve")

# eq=False: requests are identity objects (schedulers remove them from
# queues by identity)
@dataclasses.dataclass(eq=False)
class Request:
    request_id: int
    prompt: np.ndarray             # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    priority: int = 0              # larger admits first (priority policy)
    # streaming: called as on_token(request, token) for every generated
    # token, the prefill-produced first token included, in order
    on_token: Optional[Callable[["Request", int], None]] = None
    # filled by the engine:
    output: Optional[list] = None
    truncated: bool = False        # hard-stopped at max_len / page pool dry
    arrival: int = -1              # submit order (scheduler tiebreak)
    queued_ticks: int = -1         # ticks spent waiting for a slot
    ttft_ms: float = -1.0          # submit -> first token
    _t_submit: float = -1.0
    _t_last: float = -1.0          # previous token's tick timestamp
    _tick_submit: int = -1


@dataclasses.dataclass
class _PartialPrefill:
    """A chunked admission in flight: slot claimed, prefix credit mounted,
    schedule partially executed.  ``pos`` is the resume point (device KV
    rows [0, pos) are final); the slot's device cursor is pinned there
    between ticks."""
    req: Request
    schedule: List[Tuple[int, int]]
    credit: int = 0                # prefix-cache tokens mounted at staging
    next_chunk: int = 0            # index of the first unexecuted chunk
    pos: int = 0                   # tokens covered (== credit at staging)
    executed: int = 0              # chunks run so far (0 => clean unwind)
    last_tok: Optional[int] = None  # the prefill-produced first token
    paused: bool = False           # pool-dry pause seen since last batch


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_len: int = 512
    greedy: bool = True            # False: temperature sampling
    temperature: float = 1.0
    allocator: str = "paged"       # "paged" | "contiguous"
    page_size: int = 16
    num_pages: Optional[int] = None   # paged pool size (None: full capacity)
    prefill_chunk: int = 32        # max tokens per prefill step (pow2)
    prefix_cache: bool = True      # shared-prefix radix index (paged only)
    tick_budget: Optional[int] = None  # continuous batching: max tokens
                                   # (decode + padded prefill-chunk widths)
                                   # one tick may execute; None: whole-
                                   # prompt admission
    scheduler: Any = "fifo"        # admission policy name or Scheduler


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def clamp_prefill_chunk(chunk: int, max_len: int) -> int:
    """Engine-effective prefill chunk: a power of two no larger than half
    the (pow2-rounded) context."""
    return min(_next_pow2(chunk), _next_pow2(max_len) >> 1 or 1)


def prefill_schedule(prompt_len: int, *, chunk: int, max_len: int,
                     bucketed: bool, start: int = 0) -> List[Tuple[int, int]]:
    """(start, width) chunks covering [start, prompt_len).  Full chunks
    are exact; for cursor-guarded (bucketed) families the final partial
    chunk is padded to a power-of-two bucket and, near max_len,
    left-shifted over already-written positions."""
    out: List[Tuple[int, int]] = []
    pos = start
    while pos < prompt_len:
        take = min(chunk, prompt_len - pos)
        if bucketed:
            cb = _next_pow2(take)
            s = max(0, min(pos, max_len - cb))
        else:
            cb, s = take, pos
        out.append((s, cb))
        pos += take
    return out


def decode_table_width(longest: int, *, page_size: int,
                       pages_per_slot: int) -> int:
    """Bucketed block-table width for a decode tick whose longest active
    row holds ``longest`` positions (read + the written KV row), rounded
    up to a power of two."""
    need = -(-longest // page_size)
    return min(pages_per_slot, _next_pow2(max(need, 1)))


class Engine:
    def __init__(self, api: ModelApi, params, cfg: EngineConfig, *,
                 seed: int = 0, device=None):
        if cfg.allocator not in ("paged", "contiguous"):
            raise ValueError(f"unknown allocator {cfg.allocator!r}")
        want = resolve_device(device)
        self.device = params["embed"]["table"].device
        if self.device.type != want.type or (
                want.index is not None and self.device != want):
            raise ValueError(f"params live on {self.device}, the engine "
                             f"was asked to run on {want}")
        self.api = api
        self.params = params
        self.cfg = dataclasses.replace(
            cfg, prefill_chunk=clamp_prefill_chunk(cfg.prefill_chunk,
                                                   cfg.max_len))
        # the dense family's decode state is entirely cursor-guarded: KV
        # rows beyond a cursor are invalid by construction, so prefill
        # chunks pad to power-of-two buckets and every slot can be paged
        self.paged = cfg.allocator == "paged"
        forced = getattr(api.cfg.attention, "backend", None)
        if forced == "paged_pallas":
            raise ValueError(
                "backend='paged_pallas' cannot be forced engine-wide: "
                "prefill chunks are multi-query and the paged decode "
                "kernel is single-query (n_q=1).  Leave backend=None — "
                "the planner selects paged_pallas for CUDA decode ticks "
                "automatically")
        if self.paged:
            ok, why = self._paged_eligible()
            if not ok:
                log.info("paged cache unavailable (%s); using contiguous "
                         "slots", why)
                self.paged = False
        if forced == "paged" and not self.paged:
            raise ValueError(
                f"backend='paged' forced but the engine is backed by "
                f"contiguous slots (allocator={cfg.allocator!r}) — it needs "
                f"allocator='paged'")
        if self.paged:
            self.alloc = PagedAllocator(cfg.max_batch, cfg.max_len,
                                        cfg.page_size, cfg.num_pages)
            self.states = api.init_states(
                cfg.max_batch, cfg.max_len, per_slot=True, paged=True,
                page_size=cfg.page_size, num_pages=self.alloc.num_pages,
                device=self.device)
        else:
            self.alloc = SlotAllocator(cfg.max_batch)
            self.states = api.init_states(cfg.max_batch, cfg.max_len,
                                          per_slot=True, device=self.device)
        self.prefix: Optional[PrefixIndex] = None
        if self.paged and cfg.prefix_cache:
            self.prefix = PrefixIndex(self.alloc)
            self.alloc.attach_reclaimer(self.prefix.evict)
        self.scheduler = make_scheduler(cfg.scheduler)
        self.active: Dict[int, Request] = {}     # slot -> request
        self.admitting: Dict[int, _PartialPrefill] = {}
        if cfg.tick_budget is not None and cfg.tick_budget < 1:
            raise ValueError(f"tick_budget must be >= 1 (or None), got "
                             f"{cfg.tick_budget}")
        self.metrics = MetricsRegistry()
        self.metrics.counters.update({
            "prefix_hit_tokens": 0, "prefix_hit_requests": 0,
            "forked_pages": 0, "prefill_tokens": 0,
            "generated_tokens": 0, "finished_requests": 0,
            "table_uploads": 0, "table_uploads_decode": 0,
            "table_uploads_prefill": 0, "decode_ticks": 0,
            "prefill_chunks": 0, "paused_prefills": 0})
        self.counters: Dict[str, int] = self.metrics.counters
        self._arrival = 0
        self._tick = 0
        self._admission_backoff = False
        self._prefill_stalled = False
        self._progressed = False
        self._lat = {k: self.metrics.histogram(k)
                     for k in ("ttft_ms", "itl_ms", "queued_ticks")}
        self.tel = None                  # span tracer: not ported yet
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.decode_plan = self._plan_decode()
        log.info("engine decode %s [max_batch=%d max_len=%d alloc=%s "
                 "device=%s]", self.decode_plan.trace_line(), cfg.max_batch,
                 cfg.max_len, "paged" if self.paged else "contiguous",
                 self.device)
        self._prefill_buckets: set = set()       # chunk widths run
        self._decode_shapes: set = set()         # decode table widths run
        self._tables_dirty = False

    # ---- planning / introspection ----
    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill step shapes run (bounded by the bucket count)."""
        return len(self._prefill_buckets)

    @property
    def decode_compiles(self) -> int:
        """Distinct decode step shapes run (the clamped table-width
        buckets under paging, 1 for contiguous slots)."""
        return len(self._decode_shapes)

    def stats(self) -> Dict[str, Any]:
        """Serving counters: prefix-cache effectiveness, copy-on-write
        activity, cache churn, step-shape counts and latency percentiles
        (bounded reservoir histograms)."""
        s: Dict[str, Any] = dict(self.counters)
        s["prefill_compiles"] = self.prefill_compiles
        s["decode_compiles"] = self.decode_compiles
        s["scheduler"] = getattr(self.scheduler, "name",
                                 type(self.scheduler).__name__)
        if self.prefix is not None:
            s["evictions"] = self.prefix.evictions
            s["cached_pages"] = self.prefix.cached_pages
            s["prefix_lookups_hit"] = self.prefix.hits
            s["prefix_lookups_miss"] = self.prefix.misses
        else:
            s["evictions"] = 0
            s["cached_pages"] = 0
        if self.paged:
            s["pages_in_use"] = self.alloc.pages_in_use
            s["high_water_pages"] = self.alloc.high_water_pages
        s["inflight_prefills"] = len(self.admitting)
        for k, h in self._lat.items():
            s[f"{k}_p50"] = h.percentile(50)
            s[f"{k}_p99"] = h.percentile(99)
        s["latency_samples"] = {k: h.count for k, h in self._lat.items()}
        return s

    def _paged_eligible(self):
        """(ok, why_not) for backing this model's decode with the pool."""
        from repro_torch.core.mechanism import (AttnShapes, backend_eligible,
                                                get_mechanism,
                                                resolve_mechanism_name)

        acfg = self.api.cfg.attention
        forced = getattr(acfg, "backend", None)
        if forced not in (None, "paged"):
            return False, f"config forces backend={forced!r}"
        shapes = AttnShapes(
            batch=self.cfg.max_batch, n_q=1, n_k=self.cfg.max_len,
            num_heads=acfg.num_heads, num_kv_heads=acfg.num_kv_heads,
            head_dim=acfg.head_dim, dtype=self.api.cfg.cdtype,
            has_cache=True, scalar_cursor=False,
            platform=self.device.type, paged=True)
        return backend_eligible("paged", acfg, shapes,
                                get_mechanism(resolve_mechanism_name(acfg)))

    def _plan_decode(self):
        """Inspectable attention plan for the steady-state decode tick."""
        from repro_torch.core.mechanism import AttnShapes, plan_attention

        mcfg = self.api.cfg
        acfg = mcfg.attention
        if self.paged:
            n_k = self.alloc.pages_per_slot * self.cfg.page_size
        else:
            n_k = self.cfg.max_len
        shapes = AttnShapes(
            batch=self.cfg.max_batch, n_q=1, n_k=n_k,
            num_heads=acfg.num_heads, num_kv_heads=acfg.num_kv_heads,
            head_dim=acfg.head_dim, dtype=mcfg.cdtype, has_cache=True,
            scalar_cursor=False, platform=self.device.type,
            paged=self.paged)
        plan = plan_attention(acfg, shapes)
        if (plan.backend == "paged"
                and getattr(acfg, "backend", None) is None
                and not getattr(acfg, "use_kernel", False)):
            plan = dataclasses.replace(
                plan, reason=plan.reason + "; all-layer fused gather "
                "hoisted out of the layer loop")
        return plan

    # ---- steps ----
    def _select(self, logits: torch.Tensor) -> torch.Tensor:
        """(n, V) logits -> (n,) int32 next tokens (greedy or sampled)."""
        if self.cfg.greedy:
            return logits.argmax(-1).to(torch.int32)
        t = max(self.cfg.temperature, 1e-6)
        probs = torch.softmax(logits.float() / t, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].to(
            torch.int32)

    def _decode_step(self, tokens, states):
        logits, new_states = self.api.step(self.params, tokens, states, None)
        return self._select(logits[:, -1]), new_states

    def _prefill_chunk(self, tokens, states, last_idx: int):
        """One single-row prefill chunk: tokens (1, cb) into a batch-1
        state view; ``last_idx`` points at the final *real* token (bucket
        padding sits after it, causally invisible to it)."""
        logits, new_states = self.api.step(self.params, tokens, states, None)
        return self._select(logits[0, last_idx][None])[0], new_states

    # ---- batch-1 state views (single-row prefill) ----
    def _slot_view(self, slot: int) -> LayerState:
        kv = self.states.kv
        if isinstance(kv, PagedKVCache):
            # pools are shared across slots — only table/cursor narrow
            return LayerState(kv=PagedKVCache(
                kv.k, kv.v, kv.block_tables[slot:slot + 1],
                kv.length[slot:slot + 1]))
        # views into the slot's rows: the prefill writes land in place
        return LayerState(kv=KVCache(kv.k[:, slot:slot + 1],
                                     kv.v[:, slot:slot + 1],
                                     kv.length[slot:slot + 1]))

    def _merge_view(self, slot: int, view: LayerState):
        """Splice the view's cursor back (its KV writes already landed in
        the shared storage)."""
        self.states.kv.length[slot] = view.kv.length[0]

    @staticmethod
    def _set_view_cursor(view: LayerState, value: int) -> LayerState:
        kv = view.kv
        return LayerState(kv=kv._replace(
            length=torch.full_like(kv.length, value)))

    # ---- prefill scheduling ----
    def _prefill_schedule(self, prompt_len: int,
                          start: int = 0) -> List[Tuple[int, int]]:
        return prefill_schedule(prompt_len, chunk=self.cfg.prefill_chunk,
                                max_len=self.cfg.max_len, bucketed=True,
                                start=start)

    def _prefill_extent(self, prompt_len: int) -> int:
        return max((s + c for s, c in self._prefill_schedule(prompt_len)),
                   default=0)

    def _ensure_pages(self, slot: int, length: int) -> bool:
        """Grow the slot's block table to cover ``length`` positions and
        mark the device mirror stale.  False: pool exhausted."""
        grew = self.alloc.ensure(slot, length)
        if grew is None:
            return False
        if grew:
            self._tables_dirty = True
        return True

    def _exec_chunks(self, slot: int, part: _PartialPrefill, upto: int,
                     now: float) -> Optional[Request]:
        """Run schedule chunks ``[part.next_chunk, upto)`` through the
        single-row prefill.  Between ticks the slot's cursor is pinned to
        the resume point ``pos``.  Returns the request when the batch
        completed the schedule and its first token was terminal."""
        req = part.req
        prompt = np.asarray(req.prompt, np.int32)
        L = len(prompt)
        part.paused = False
        view = self._slot_view(slot)
        nxt = None
        last_i = len(part.schedule) - 1
        for i in range(part.next_chunk, upto):
            start, cb = part.schedule[i]
            real = min(start + cb, L) - start
            toks = np.zeros((1, cb), np.int32)
            toks[0, :real] = prompt[start:start + real]
            view = self._set_view_cursor(view, start)
            last = L - 1 - start if i == last_i else real - 1
            self._prefill_buckets.add(cb)
            self.counters["prefill_chunks"] += 1
            nxt, view = self._prefill_chunk(
                torch.from_numpy(toks).to(self.device), view, last)
            # each schedule entry covers exactly min(chunk, L - pos) new
            # tokens (left-shifted windows rewrite, they don't advance)
            part.pos = min(part.pos + self.cfg.prefill_chunk, L)
            part.executed += 1
        part.next_chunk = upto
        self._progressed = True
        done = upto == len(part.schedule)
        view = self._set_view_cursor(view, L if done else part.pos)
        self._merge_view(slot, view)
        self.alloc.slots[slot].length = part.pos
        if not done:
            log.debug("request %d prefilled to %d/%d tokens (chunk %d/%d)",
                      req.request_id, part.pos, L, part.next_chunk,
                      len(part.schedule))
            return None
        part.last_tok = int(nxt)
        return self._complete_admission(slot, now)

    # ---- public API ----
    def submit(self, req: Request):
        arr = np.asarray(req.prompt)
        if arr.ndim != 1:
            raise ValueError(
                f"prompt must be 1-D (token ids), got shape {arr.shape}")
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(
                f"prompt must be an integer array, got dtype {arr.dtype}")
        req.prompt = arr.astype(np.int32, copy=True)
        plen = len(req.prompt)
        if plen < 1:
            raise ValueError("empty prompt")
        if plen >= self.cfg.max_len:
            raise ValueError(
                f"prompt_len={plen} >= max_len={self.cfg.max_len}: the KV "
                f"buffer cannot hold the prompt plus one generated token")
        if self.paged:
            need = -(-max(self._prefill_extent(plen), plen + 1)
                     // self.cfg.page_size)
            if need > self.alloc.num_pages - 1:
                raise ValueError(
                    f"prompt needs {need} pages but the pool holds "
                    f"{self.alloc.num_pages - 1}")
        req.output = []
        req.truncated = False
        req.arrival = self._arrival
        req._t_submit = time.perf_counter()
        req._tick_submit = self._tick
        self._arrival += 1
        self.scheduler.add(req)

    def _prefix_credit(self, req: Request) -> Tuple[int, List[int]]:
        """(tokens, pages) of the longest usable cached prefix: page-aligned,
        capped so at least one prompt token is always prefilled."""
        if self.prefix is None:
            return 0, []
        m, pages = self.prefix.match(req.prompt)
        ps = self.cfg.page_size
        cap = ((len(req.prompt) - 1) // ps) * ps
        m = min(m, cap)
        return m, pages[:m // ps]

    def _copy_page(self, old: int, new: int):
        """Device half of a CoW fork: copy pool page ``old`` -> ``new``
        across all layers, in place."""
        kv = self.states.kv
        kv.k[:, new] = kv.k[:, old]
        kv.v[:, new] = kv.v[:, old]

    def _flush_tables(self, where: str = "decode"):
        """Mirror the host block tables into the device state in one
        batched host->device copy, when any row changed."""
        if not (self.paged and self._tables_dirty):
            return
        self.states.kv.block_tables.copy_(
            torch.from_numpy(self.alloc.block_tables))
        self._tables_dirty = False
        self.counters["table_uploads"] += 1
        self.counters[f"table_uploads_{where}"] += 1

    def _set_cursor(self, slot: int, value: int):
        """Device-side edit of one slot's cursor (no host transfer)."""
        self.states.kv.length[slot] = value

    def _scrub_slot_device(self, slot: int):
        """Retire an inactive slot's device row: its cursor goes to 0 and
        its (host-zeroed) table row rides the next flush, so the row's
        garbage decode write lands on the trash page."""
        self._set_cursor(slot, 0)
        self._tables_dirty = True

    def _stage_slot(self, slot: int, req: Request, credit: int,
                    pages: List[int]) -> List[Tuple[int, int]]:
        """Mount the prefix credit and fix the admission's schedule."""
        if credit:
            self.alloc.map_shared(slot, pages)
            self._tables_dirty = True
        return self._prefill_schedule(len(req.prompt), start=credit)

    def _reserve_chunks(self, slot: int, part: _PartialPrefill,
                        upto: int) -> bool:
        """Grow the table and CoW-fork shared pages for schedule chunks
        ``[part.next_chunk, upto)``.  False when the pool ran dry."""
        if not self.paged or upto <= part.next_chunk:
            return True
        chunks = part.schedule[part.next_chunk:upto]
        need = max(s + c for s, c in chunks)
        if upto == len(part.schedule):
            # the final batch also covers the first decode tick's KV row
            need = max(need, len(part.req.prompt) + 1)
        if not self._ensure_pages(slot, need):
            return False
        if part.credit:
            # copy-on-write: the only writes below the credit are
            # near-max_len bucketed chunks left-shifting over written
            # positions; fork the shared pages they touch first
            ps = self.cfg.page_size
            for start, cb in chunks:
                if start >= part.credit:
                    continue
                lo = start // ps
                hi = -(-min(start + cb, part.credit) // ps)
                for lp in range(lo, hi):
                    if self.alloc.writable(slot, lp):
                        continue
                    fork = self.alloc.fork(slot, lp)
                    if fork is None:
                        return False
                    self._copy_page(*fork)
                    self._tables_dirty = True
                    self.counters["forked_pages"] += 1
        return True

    def _plan_chunks(self, part: _PartialPrefill, quota: Optional[int],
                     spent: int) -> int:
        """How far into the schedule this tick may execute (chunk index).
        The budget charges padded widths; the tick's first chunk always
        fits when the quota is positive."""
        upto, cost = part.next_chunk, 0
        for _s, cb in part.schedule[part.next_chunk:]:
            if quota is not None and spent + cost + cb > quota and (
                    spent or cost or quota <= 0):
                break
            upto += 1
            cost += cb
        return upto

    def _batch_cost(self, part: _PartialPrefill, upto: int) -> int:
        return sum(cb for _s, cb in part.schedule[part.next_chunk:upto])

    def _append_token(self, req: Request, tok: int,
                      now: Optional[float] = None):
        """Record a generated token, stamp its latency sample, and fire
        the streaming callback."""
        tok = int(tok)
        req.output.append(tok)
        self.counters["generated_tokens"] += 1
        if now is not None:
            if len(req.output) == 1:
                req.ttft_ms = (now - req._t_submit) * 1e3
                self._lat["ttft_ms"].record(req.ttft_ms)
            else:
                self._lat["itl_ms"].record((now - req._t_last) * 1e3)
            req._t_last = now
        if req.on_token is not None:
            try:
                req.on_token(req, tok)
            except Exception:   # noqa: BLE001 — a user callback must not
                log.exception(  # kill the serving loop
                    "on_token callback failed for request %d",
                    req.request_id)

    def _unwind_slot(self, slot: int):
        """Give a claimed slot and its pages back; scrub its device row."""
        self.alloc.release(slot)
        if self.paged:
            self._scrub_slot_device(slot)

    def _complete_admission(self, slot: int,
                            now: float) -> Optional[Request]:
        """Promote a fully prefilled partial to an active slot.  Returns
        the request when its first token was terminal."""
        part = self.admitting.pop(slot)
        req = part.req
        self.active[slot] = req
        self.alloc.slots[slot].length = len(req.prompt)
        self.counters["prefill_tokens"] += len(req.prompt) - part.credit
        if part.credit:
            self.counters["prefix_hit_tokens"] += part.credit
            self.counters["prefix_hit_requests"] += 1
        self._append_token(req, part.last_tok, now)
        nxt = req.output[-1]
        if (len(req.output) >= req.max_new_tokens
                or (req.eos_id is not None and nxt == req.eos_id)):
            return self._finish(slot)
        return None

    def _advance_one(self, slot: int, quota: Optional[int], spent: int,
                     now: float, reserved_upto: Optional[int] = None
                     ) -> Tuple[int, Optional[Request]]:
        """Advance one in-progress admission by this tick's share of the
        budget.  Returns (padded tokens spent, finished request or None).
        A reservation failure on a zero-progress credit admission re-stages
        uncached; any other failure pauses the partial in place."""
        part = self.admitting[slot]
        upto = reserved_upto
        if upto is not None:
            if upto == part.next_chunk:
                return 0, None
        else:
            upto = self._plan_chunks(part, quota, spent)
            if upto == part.next_chunk:
                return 0, None
            if not self._reserve_chunks(slot, part, upto):
                if part.credit and part.executed == 0:
                    req = part.req
                    del self.admitting[slot]
                    self._unwind_slot(slot)
                    slot2 = self.alloc.claim(req.request_id)
                    self.admitting[slot2] = _PartialPrefill(
                        req=req, schedule=self._stage_slot(slot2, req, 0, []))
                    self._set_cursor(slot2, 0)
                    if self.paged:
                        self._tables_dirty = True
                    return self._advance_one(slot2, quota, spent, now)
                self._prefill_stalled = True
                part.paused = True
                self.counters["paused_prefills"] += 1
                log.debug("request %d paused mid-prefill at %d/%d tokens "
                          "(page pool dry)", part.req.request_id, part.pos,
                          len(part.req.prompt))
                return 0, None
        cost = self._batch_cost(part, upto)
        self._flush_tables("prefill")
        return cost, self._exec_chunks(slot, part, upto, now)

    def _run_prefills(self, quota: Optional[int],
                      now: float) -> List[Request]:
        """The tick's chunked-prefill pass: resume in-progress admissions
        first (staging order), then admit from the scheduler while slots
        and budget allow."""
        finished: List[Request] = []
        self._admission_backoff = False
        self._prefill_stalled = False
        spent = 0
        for slot in list(self.admitting):
            if slot not in self.admitting:
                continue        # re-staged uncached under a new slot id
            cost, fin = self._advance_one(slot, quota, spent, now)
            spent += cost
            if fin is not None:
                finished.append(fin)
        while len(self.scheduler):
            req = self.scheduler.next(self)
            if req is None:
                break
            slot = self.alloc.claim(req.request_id)
            if slot is None:
                self._admission_backoff = True
                break
            credit, pages = self._prefix_credit(req)
            part = _PartialPrefill(
                req=req, schedule=self._stage_slot(slot, req, credit, pages),
                credit=credit, pos=credit)
            # reserve the first chunk batch BEFORE dequeuing: a pool-dry
            # admission unwinds with the request still queued
            upto = self._plan_chunks(part, quota, spent)
            if not self._reserve_chunks(slot, part, upto):
                self._unwind_slot(slot)
                if credit:
                    # the cache must never block an admission an empty
                    # cache would allow — retry uncached
                    slot = self.alloc.claim(req.request_id)
                    credit, pages = 0, []
                    part = _PartialPrefill(
                        req=req,
                        schedule=self._stage_slot(slot, req, 0, []))
                    upto = self._plan_chunks(part, quota, spent)
                    if not self._reserve_chunks(slot, part, upto):
                        self._unwind_slot(slot)
                        self._admission_backoff = True
                        break
                else:
                    self._admission_backoff = True
                    break
            self.scheduler.remove(req)
            req.queued_ticks = max(0, self._tick - req._tick_submit - 1)
            self._lat["queued_ticks"].record(req.queued_ticks)
            self.admitting[slot] = part
            self._progressed = True
            # reset the slot's cursor; a credit-mounted partial pins it at
            # the resume point right away, so its decode-tick garbage
            # write lands past the mount, never on a shared page
            self._set_cursor(slot, part.pos)
            if self.paged:
                self._tables_dirty = True
            cost, fin = self._advance_one(slot, quota, spent, now,
                                          reserved_upto=upto)
            spent += cost
            if fin is not None:
                finished.append(fin)
        return finished

    def cancel(self, request_id: int) -> bool:
        """Abort a request wherever it lives (queued, mid-prefill or
        decoding).  False when the id is unknown."""
        for req in self.scheduler.pending():
            if req.request_id == request_id:
                self.scheduler.remove(req)
                req.truncated = True
                return True
        for slot, part in list(self.admitting.items()):
            if part.req.request_id == request_id:
                del self.admitting[slot]
                self._unwind_slot(slot)
                part.req.truncated = True
                return True
        for slot, req in list(self.active.items()):
            if req.request_id == request_id:
                req.truncated = True
                self._finish(slot)
                return True
        return False

    def _finish(self, slot: int) -> Request:
        req = self.active.pop(slot)
        self.counters["finished_requests"] += 1
        if self.prefix is not None:
            # cache the finished sequence: every written KV row is valid
            rows = self.alloc.slots[slot].length
            toks = np.concatenate([
                req.prompt,
                np.asarray(req.output[:max(0, rows - len(req.prompt))],
                           np.int32)])
            self.prefix.insert(toks[:rows], self.alloc.held(slot))
        self.alloc.release(slot)
        if self.paged:
            self._scrub_slot_device(slot)
        return req

    def step(self) -> List[Request]:
        """One engine tick. Returns requests that finished this tick."""
        # grow in-flight slots' tables for this tick's KV row BEFORE
        # admitting (decoding requests have page priority); slots at
        # max_len hard-stop
        self._tick += 1
        self._progressed = False
        now = time.perf_counter()
        finished: List[Request] = []
        for slot in list(self.active):
            req = self.active[slot]
            if self.alloc.slots[slot].length >= self.cfg.max_len or (
                    self.paged and not self._ensure_pages(
                        slot, self.alloc.slots[slot].length + 1)):
                req.truncated = True
                finished.append(self._finish(slot))
        quota = self.scheduler.prefill_quota(self, len(self.active))
        finished.extend(self._run_prefills(quota, now))
        if not self.active:
            return finished
        last = np.zeros((self.cfg.max_batch, 1), np.int32)
        for slot, req in self.active.items():
            last[slot, 0] = req.output[-1]
        # the tick's one batched table upload, then clamp the decode
        # tick's table width to the bucketed high-water page count (the
        # kernel / gather then walks only pages a row can hold)
        self._flush_tables("decode")
        last_dev = torch.from_numpy(last).to(self.device)
        states_in, full_tables = self.states, None
        if self.paged:
            hw = self._decode_table_width()
            kv = self.states.kv
            full_tables = kv.block_tables
            states_in = LayerState(kv=kv._replace(
                block_tables=full_tables[:, :hw].contiguous()))
            self._decode_shapes.add(hw)
        else:
            self._decode_shapes.add("contiguous")
        nxt, new_states = self._decode_step(last_dev, states_in)
        if full_tables is not None:
            new_states = LayerState(kv=new_states.kv._replace(
                block_tables=full_tables))
        self.states = new_states
        self.counters["decode_ticks"] += 1
        if self.admitting:
            # mid-prefill rows rode this tick as inactive rows: re-pin
            # their cursors at the resume point
            for slot, part in self.admitting.items():
                self._set_cursor(slot, part.pos)
        self._progressed = True
        nxt = nxt.cpu().numpy()     # the tick's one device->host readback
        for slot in list(self.active):
            req = self.active[slot]
            self._append_token(req, nxt[slot], now)
            self.alloc.slots[slot].length += 1
            if (len(req.output) >= req.max_new_tokens
                    or (req.eos_id is not None
                        and req.output[-1] == req.eos_id)):
                finished.append(self._finish(slot))
        return finished

    def _decode_table_width(self) -> int:
        """Bucketed high-water page count across active AND mid-prefill
        slots (their pinned-cursor garbage write scatters at ``pos``)."""
        rows = [self.alloc.slots[s].length for s in self.active]
        rows += [part.pos for part in self.admitting.values()]
        longest = max(rows) + 1
        return decode_table_width(longest, page_size=self.cfg.page_size,
                                  pages_per_slot=self.alloc.pages_per_slot)

    def run_to_completion(self, max_ticks: int = 10_000,
                          on_tick=None) -> List[Request]:
        """Drive ticks until the engine drains; raises when a tick can make
        no progress (no active slot, nothing finished or advanced, and an
        admission backed off or a prefill stalled)."""
        done: List[Request] = []
        for _ in range(max_ticks):
            out = self.step()
            done.extend(out)
            if on_tick is not None:
                on_tick(self, out)
            if (not self.active and not self.admitting
                    and not len(self.scheduler)):
                break
            if (not self.active and not out and not self._progressed
                    and (self._admission_backoff
                         or self._prefill_stalled)):
                head = self.scheduler.next(self)
                head_desc = (f"id={head.request_id}, "
                             f"prompt_len={len(head.prompt)}"
                             if head is not None else "deferred")
                raise RuntimeError(
                    f"engine cannot make progress: {len(self.scheduler)} "
                    f"request(s) queued (head: {head_desc}), "
                    f"{len(self.admitting)} mid-prefill, no active "
                    f"slots, and admission backed off or stalled"
                    + (f" [pages_in_use={self.alloc.pages_in_use}/"
                       f"{self.alloc.num_pages - 1}]" if self.paged else
                       ""))
        return done
