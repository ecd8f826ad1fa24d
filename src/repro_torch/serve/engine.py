"""Batched serving engine with continuous batching.

Port of :mod:`repro.serve.engine`:

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
    copy on the device, outside any graph).
  * Host block tables are authoritative; the device mirror is refreshed
    in one batched upload per tick when dirty.
  * The attention-free ``ssm`` family (RWKV-6) has no KV cache: its
    per-slot recurrent state (``models.rwkv.RwkvLayerState``) lives in
    contiguous slots (``allocator="paged"`` is logged and downgraded),
    with no prefix cache and no decode plan.  Its prompts prefill in
    exact-length chunks through ``api.step`` with the slot's carried
    state (pad tokens would enter the carry), whole at admission
    (``tick_budget`` is logged as ignored), and decode runs ``lm_step``'s
    exact scan: no kernel runs on this path, as in the reference.
    Admission zeroes the slot's state rows in place.
  * The ``moe`` family serves as ``dense`` does (bucketed, paged, prefix
    cache).  The ``hybrid`` family (attention ∥ Mamba) is paged, but its
    Mamba carries (``LayerState.ssm`` / ``conv``) would absorb pad tokens
    and cannot skip a cached prefix: its prompts prefill whole at
    admission in exact-length chunks, eagerly, with no prefix cache, and
    admission zeroes the slot's carries in place beside pinning its
    cursor.  Its decode ticks run the paged decode kernels like any
    paged family's.
  * The ``vlm`` family serves text prompts as ``dense`` does: a
    ``Request`` carries no image embeddings, in the reference too.  The
    ``encdec`` family is refused at construction: its step decodes
    against the encoder's memory (``batch["memory"]``), which no
    request carries, so the reference's engine cannot serve it either.

**Static steps (the reference's jit per bucket).**  Each decode table
width ``hw`` (one step for contiguous slots) and each prefill chunk
width ``cb`` gets one :class:`_StaticStep`: static input buffers (the
decode token batch; a prefill chunk's tokens, table row and cursor),
a body that runs ``api.step`` on the engine's state and writes its
outputs in place (the new cursors into the state's length tensor, the
logits it needs into a static output), and on ``cuda`` a
``torch.cuda.CUDAGraph`` captured from the body after its first, eager
run — the real tick, during which the kernel registry times the paged
kernels' launch candidates (timing synchronizes, so it never runs inside
a capture).  Later ticks at the bucket replay the graph; all graphs
share one memory pool.  On the CPU the same step runs its body each
time, so capture is the only difference between the card and the CPU.
A recurrent family's decode step (one signature, ``(max_batch, 1)``
tokens over contiguous slots) is captured the same way; its prefill
steps, one per exact chunk width, run eagerly on the card too (the
widths form an unbounded set), and each still counts as one step built,
as the reference's jit traces one per width.
The state's tensors are the engine's for its life: every edit
(cursors, tables, page copies, KV writes) lands in place.  Sampling
stays outside the graph (argmax or multinomial on the static logits),
and a failed capture or replay raises: there is no eager fallback.

``prefill_compiles`` / ``decode_compiles`` count the static steps built;
``EngineConfig.warmup`` ("decode" / "serve") builds the enumerated
buckets at construction (with the tables zeroed, so warm-up writes land
on the trash page, and the cursors restored), and the drain checks the
counts against the proven retrace budget
(``repro_torch.analysis.serve_static``).  ``EngineConfig.telemetry``
turns on the span tracer and flight recorder (``serve.telemetry``): the
tick's phases on the engine track (inside ``tick``: ``prefill_pass``,
whose admissions run inside ``scheduler``, with a ``prefill_chunk``
around each chunk's step; then ``decode_step``, and ``emit``: the token
appends, callbacks and finishing after the readback), each mirrored as a
``torch.profiler`` range; off,
``Engine.tel`` is None and every hook is one ``is not None`` test.
A token's latency samples (``Engine.stats()``' ``ttft_ms`` and
``itl_ms``) are stamped on the host clock just after the readback that
delivered it.
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
from repro_torch.kernels import ops as kops
from repro_torch.models.registry import ModelApi
from repro_torch.models.transformer import LayerState
from repro_torch.serve.kvcache import PagedAllocator, SlotAllocator
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.scheduler import make_scheduler
from repro_torch.serve.telemetry import (MetricsRegistry, dump_flight,
                                         make_tracer)

log = logging.getLogger("repro_torch.serve")

# families whose decode state is entirely cursor-guarded: KV rows beyond
# the cursor are invalid by construction, so padded prefill buckets are
# safe.  Recurrent carries (ssm / rwkv) would absorb pad tokens, so those
# families prefill in exact-length chunks instead.
_KV_FAMILIES = ("dense", "moe", "vlm")
_PAGEABLE_FAMILIES = ("dense", "moe", "hybrid", "vlm")

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
    telemetry: Any = None          # None/False: no tracer; True/"on":
                                   # span trace + flight ring; "flight":
                                   # ring only; or a TelemetryConfig /
                                   # Tracer (serve.telemetry.make_tracer)
    warmup: str = "none"           # "decode": build (on cuda: capture)
                                   # every proven decode bucket at
                                   # construction; "serve": the prefill
                                   # chunk buckets too


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


class _StaticStep:
    """One static step of a bucket (``kind`` "decode" or "prefill",
    ``width`` its table width, "contiguous", or its chunk width).

    ``body`` reads the static input buffers set by the engine (``tokens``;
    for a prefill chunk also ``cursor`` and ``table`` or ``slot``), runs
    ``api.step`` and writes in place: the state's KV rows and cursors, and
    the logits the engine reads into ``out``.  The first call runs the
    body eagerly, then hands the step to ``capture`` (the engine's, on
    ``cuda``), which records ``graph`` and ``captured`` (the kernel
    launches the capture recorded); every later call replays the graph and
    adds ``captured`` to the kernel counts.  Without ``capture`` (the CPU)
    every call runs the body."""

    def __init__(self, kind: str, width, body: Callable[[], None],
                 capture: Optional[Callable[["_StaticStep"], None]]):
        self.kind = kind
        self.width = width
        self.body = body
        self.capture = capture
        self.tokens: Optional[torch.Tensor] = None
        self.cursor: Optional[torch.Tensor] = None
        self.table: Optional[torch.Tensor] = None
        self.slot: Optional[torch.Tensor] = None
        self.out: Optional[torch.Tensor] = None
        self.graph = None
        self.captured: Dict[str, int] = {}
        self.runs = 0              # eager runs of the body
        self.replays = 0

    def __call__(self) -> None:
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            kops.add_counts(self.captured)
            return
        self.body()
        self.runs += 1
        if self.capture is not None:
            self.capture(self)


class Engine:
    def __init__(self, api: ModelApi, params, cfg: EngineConfig, *,
                 seed: int = 0, device=None):
        if cfg.allocator not in ("paged", "contiguous"):
            raise ValueError(f"unknown allocator {cfg.allocator!r}")
        if cfg.warmup not in ("none", "decode", "serve"):
            raise ValueError(f"unknown warmup policy {cfg.warmup!r} "
                             f"(expected 'none', 'decode' or 'serve')")
        if api.cfg.family == "encdec":
            raise ValueError(
                "the engine cannot serve the encoder-decoder family: its "
                "decode step needs the encoder's memory (batch['memory']), "
                "which a Request does not carry")
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
        fam = api.cfg.family
        self.paged = cfg.allocator == "paged" and fam in _PAGEABLE_FAMILIES
        if cfg.allocator == "paged" and not self.paged:
            log.info("family %r has no pageable KV cache; using contiguous "
                     "slots", fam)
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
                f"contiguous slots (allocator={cfg.allocator!r}, family "
                f"{fam!r}) — it needs allocator='paged' and a pageable "
                f"family")
        self._bucketed = fam in _KV_FAMILIES
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
        # the hybrid family's Mamba carries, beside its KV cache
        self._carries = (isinstance(self.states, LayerState)
                         and self.states.ssm is not None)
        # shared-prefix radix cache over the paged pool, for KV-pure
        # families only: a recurrent carry cannot skip the prefix compute
        self.prefix: Optional[PrefixIndex] = None
        if self.paged and cfg.prefix_cache and fam in _KV_FAMILIES:
            self.prefix = PrefixIndex(self.alloc)
            self.alloc.attach_reclaimer(self._reclaim_pages)
        elif cfg.prefix_cache and self.paged:
            log.info("prefix cache unavailable for family %r (recurrent "
                     "carries cannot skip prefill)", fam)
        self.scheduler = make_scheduler(cfg.scheduler)
        self.active: Dict[int, Request] = {}     # slot -> request
        self.admitting: Dict[int, _PartialPrefill] = {}
        if cfg.tick_budget is not None:
            if cfg.tick_budget < 1:
                raise ValueError(f"tick_budget must be >= 1 (or None), got "
                                 f"{cfg.tick_budget}")
            if not self._bucketed:
                log.info("family %r prefills exact-length whole prompts "
                         "(recurrent carries); tick_budget ignored", fam)
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
        # span tracer + flight recorder, or None: every hook below is one
        # attribute load and an is-None test, and the emit path makes no
        # host<->device transfer (analysis.serve_static
        # .audit_telemetry_file)
        self.tel = make_tracer(cfg.telemetry)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.decode_plan = self._plan_decode()
        if self.decode_plan is not None:
            log.info("engine decode %s [max_batch=%d max_len=%d alloc=%s "
                     "device=%s]", self.decode_plan.trace_line(),
                     cfg.max_batch, cfg.max_len,
                     "paged" if self.paged else "contiguous", self.device)
        if self.tel is not None:
            self.tel.set_meta("engine", {
                "family": fam, "max_batch": cfg.max_batch,
                "max_len": cfg.max_len,
                "allocator": "paged" if self.paged else "contiguous",
                "page_size": cfg.page_size,
                "prefill_chunk": self.cfg.prefill_chunk,
                "tick_budget": cfg.tick_budget,
                "prefix_cache": self.prefix is not None,
                "device": str(self.device)})
            if self.decode_plan is not None:
                self.tel.set_meta("decode_plan", {
                    "mechanism": self.decode_plan.mechanism,
                    "backend": self.decode_plan.backend,
                    "reason": self.decode_plan.reason})
        # the static steps, one per bucket: their count is the live
        # compile count, checked against the proven retrace budget at
        # drain (measured > proven = soundness bug)
        self._decode_steps: Dict[Any, _StaticStep] = {}
        self._prefill_steps: Dict[int, _StaticStep] = {}
        self._graph_pool = None
        self._tables_dirty = False
        self._retrace_budget_cache: Optional[Dict[str, Any]] = None
        if self.cfg.warmup in ("decode", "serve"):
            self._warmup_decode()
        if self.cfg.warmup == "serve":
            self._warmup_prefill()

    # ---- planning / introspection ----
    @property
    def queue(self):
        """The scheduler, under the reference's older attribute name
        (len() / truthiness: requests waiting for admission)."""
        return self.scheduler

    @property
    def prefill_compiles(self) -> int:
        """Static prefill steps built, one per chunk width (bounded by the
        bucket count, not by the distinct prompt lengths)."""
        return len(self._prefill_steps)

    @property
    def decode_compiles(self) -> int:
        """Static decode steps built: one per clamped table-width bucket
        under paging (at most log2(pages_per_slot)+1), 1 for contiguous
        slots."""
        return len(self._decode_steps)

    def graph_stats(self) -> Dict[str, Any]:
        """Captures, replays and eager runs of the static steps, and the
        kernel launches the replays made (replays × captured)."""
        steps = list(self._decode_steps.values()) + list(
            self._prefill_steps.values())
        launches: Dict[str, int] = {}
        for st in steps:
            for name, n in st.captured.items():
                launches[name] = launches.get(name, 0) + n * st.replays
        return {
            "captures": sum(st.graph is not None for st in steps),
            "replays": sum(st.replays for st in steps),
            "eager_runs": sum(st.runs for st in steps),
            "decode_replays": sum(st.replays for st in
                                  self._decode_steps.values()),
            "replayed_launches": launches,
        }

    def retrace_budget(self) -> Dict[str, Any]:
        """Proven compile budget for this engine's config, as derived by
        the static analyzer (``repro_torch.analysis.serve_static``).  The
        live ``prefill_compiles`` / ``decode_compiles`` must never exceed
        the proven counts."""
        if self._retrace_budget_cache is None:
            from repro_torch.analysis.serve_static import retrace_budget

            b = retrace_budget(
                bucketed=self._bucketed, paged=self.paged,
                max_len=self.cfg.max_len,
                prefill_chunk=self.cfg.prefill_chunk,
                page_size=self.cfg.page_size,
                pages_per_slot=(self.alloc.pages_per_slot
                                if self.paged else None),
                prefix_cache=self.prefix is not None)
            self._retrace_budget_cache = {
                "prefill_proven": b["prefill"]["proven"],
                "decode_proven": b["decode"]["proven"],
                "chunk_resume_closed": b["chunk_resume"]["closed"],
                "within_declared": b["within_budget"]}
        return dict(self._retrace_budget_cache)

    def stats(self) -> Dict[str, Any]:
        """Serving counters: prefix-cache effectiveness, copy-on-write
        activity, cache churn, compile and graph accounting and latency
        percentiles (bounded reservoir histograms)."""
        s: Dict[str, Any] = dict(self.counters)
        s["prefill_compiles"] = self.prefill_compiles
        s["decode_compiles"] = self.decode_compiles
        s["retrace_budget"] = self.retrace_budget()
        s["graphs"] = self.graph_stats()
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

    def _reclaim_pages(self, need: int) -> int:
        """Allocator reclaim hook: LRU-evict cached prefix pages, and put
        the eviction on the tick timeline when tracing."""
        freed = self.prefix.evict(need)
        if self.tel is not None and freed:
            self.tel.instant("eviction", need_pages=need, freed_pages=freed)
        return freed

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
        """Inspectable attention plan for the steady-state decode tick;
        None for the attention-free family (rwkv)."""
        from repro_torch.core.mechanism import AttnShapes, plan_attention

        mcfg = self.api.cfg
        if mcfg.family == "ssm":
            return None
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

    # ---- static steps ----
    def _select(self, logits: torch.Tensor) -> torch.Tensor:
        """(n, V) logits -> (n,) int32 next tokens (greedy or sampled),
        outside any graph."""
        if self.cfg.greedy:
            return logits.argmax(-1).to(torch.int32)
        t = max(self.cfg.temperature, 1e-6)
        probs = torch.softmax(logits.float() / t, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].to(
            torch.int32)

    def _capture(self, step: _StaticStep) -> None:
        """Capture ``step``'s body into a CUDA graph in the engine's shared
        pool.  The body ran eagerly just before (the kernel library is
        built and the paged kernels tuned), and a capture executes
        nothing, so no KV row is written and no cursor advances twice.
        The wrappers' counts bumped while capturing are taken back: the
        launches happen at each replay."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = kops.counts()
        with torch.cuda.graph(graph, pool=self._graph_pool):
            step.body()
        after = kops.counts()
        step.captured = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        kops.add_counts({k: -n for k, n in step.captured.items()})
        step.graph = graph

    def _build_step(self, kind: str, width) -> _StaticStep:
        """A new static step for a decode table width (or "contiguous")
        or a prefill chunk width, with its static input buffers.  The
        exact-length prefill widths of a recurrent family form an
        unbounded set, so those steps run eagerly, never captured."""
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        capture = self._capture if dev.type == "cuda" and (
            kind == "decode" or self._bucketed) else None
        if kind == "decode":
            step = _StaticStep(kind, width, lambda: self._decode_body(step),
                               capture)
            step.tokens = torch.zeros((self.cfg.max_batch, 1), **i32)
        else:
            step = _StaticStep(kind, width,
                               lambda: self._prefill_body(step), capture)
            step.tokens = torch.zeros((1, width), **i32)
            if isinstance(self.states, LayerState):
                step.cursor = torch.zeros((1,), **i32)
            if self.paged:
                step.table = torch.zeros(
                    (1, self.alloc.pages_per_slot), **i32)
            if not self.paged or self._carries:
                step.slot = torch.zeros((1,), dtype=torch.int64, device=dev)
        return step

    def _write_out(self, step: _StaticStep, logits: torch.Tensor) -> None:
        if step.out is None:       # the first run is eager, never captured
            step.out = torch.empty_like(logits)
        step.out.copy_(logits)

    def _decode_body(self, step: _StaticStep) -> None:
        """Decode tick over the whole batch: the static token batch, the
        engine's state (its block tables clamped to the bucket's width).
        A recurrent state, and the hybrid family's Mamba carries, are
        copied back into the engine's own tensors."""
        if not isinstance(self.states, LayerState):
            with torch.no_grad():
                logits, new = self.api.step(self.params, step.tokens,
                                            self.states, None)
            for dst, src in zip(self.states, new):
                dst.copy_(src)
            self._write_out(step, logits[:, -1])
            return
        kv = self.states.kv
        states_in = self.states
        if self.paged:
            states_in = states_in._replace(kv=kv._replace(
                block_tables=kv.block_tables[:, :step.width].contiguous()))
        with torch.no_grad():
            logits, new = self.api.step(self.params, step.tokens, states_in,
                                        None)
        kv.length.copy_(new.kv.length)
        if self._carries:
            self.states.ssm.copy_(new.ssm)
            self.states.conv.copy_(new.conv)
        self._write_out(step, logits[:, -1])

    def _prefill_body(self, step: _StaticStep) -> None:
        """One single-row prefill chunk: the static chunk tokens into a
        batch-1 view at the static cursor.  Paged: the pools are shared
        and written in place, the view's table is the static row.
        Contiguous: the slot's rows are gathered by the static slot index
        and scattered back after the step; a recurrent state the same way,
        with no cursor (its chunks are exact-length), and so are the
        hybrid family's Mamba carries."""
        if not isinstance(self.states, LayerState):
            view = type(self.states)(*(x.index_select(1, step.slot)
                                       for x in self.states))
            with torch.no_grad():
                logits, new = self.api.step(self.params, step.tokens, view,
                                            None)
            for dst, src in zip(self.states, new):
                dst.index_copy_(1, step.slot, src.to(dst.dtype))
            self._write_out(step, logits)
            return
        st = self.states
        kv = st.kv
        if self.paged:
            view = PagedKVCache(kv.k, kv.v, step.table, step.cursor)
        else:
            view = KVCache(kv.k.index_select(1, step.slot),
                           kv.v.index_select(1, step.slot), step.cursor)
        states_in = LayerState(kv=view)
        if self._carries:
            states_in = states_in._replace(
                ssm=st.ssm.index_select(1, step.slot),
                conv=st.conv.index_select(1, step.slot))
        with torch.no_grad():
            logits, new = self.api.step(self.params, step.tokens, states_in,
                                        None)
        if not self.paged:
            kv.k.index_copy_(1, step.slot, view.k)
            kv.v.index_copy_(1, step.slot, view.v)
        if self._carries:
            st.ssm.index_copy_(1, step.slot, new.ssm)
            st.conv.index_copy_(1, step.slot, new.conv)
        step.cursor.copy_(new.kv.length)
        self._write_out(step, logits)

    def _decode_step_for(self, width) -> _StaticStep:
        step = self._decode_steps.get(width)
        if step is None:
            step = self._decode_steps[width] = self._build_step("decode",
                                                                width)
        return step

    def _prefill_step_for(self, width: int) -> _StaticStep:
        step = self._prefill_steps.get(width)
        if step is None:
            step = self._prefill_steps[width] = self._build_step("prefill",
                                                                 width)
        return step

    def _warmup_state(self) -> List[torch.Tensor]:
        """The state tensors a warm-up's eager runs change, to be
        restored after: the cursors of a KV cache (and the Mamba carries
        beside it), every tensor of a recurrent state."""
        if isinstance(self.states, LayerState):
            if self._carries:
                return [self.states.kv.length, self.states.ssm,
                        self.states.conv]
            return [self.states.kv.length]
        return list(self.states)

    def _warmup_decode(self) -> None:
        """Build (on cuda: tune and capture) the decode step of every
        proven table-width bucket at construction, so no serving tick
        builds one.  The tables are zeroed (every write lands on the trash
        page 0) and the cursors, or the recurrent state, restored after
        each bucket's eager run."""
        from repro_torch.analysis.serve_static import enumerate_decode_buckets

        live = self._warmup_state()
        saved = [x.clone() for x in live]
        widths: List[Any] = ["contiguous"]
        if self.paged:
            kv = self.states.kv
            tables = kv.block_tables.clone()
            kv.block_tables.zero_()
            widths = enumerate_decode_buckets(
                max_len=self.cfg.max_len, page_size=self.cfg.page_size,
                pages_per_slot=self.alloc.pages_per_slot)
        for hw in widths:
            step = self._decode_step_for(hw)
            if step.runs == 0:
                step.tokens.zero_()
                step()
                for dst, src in zip(live, saved):
                    dst.copy_(src)
        if self.paged:
            kv.block_tables.copy_(tables)

    def _warmup_prefill(self) -> None:
        """Build the proven prefill chunk buckets at construction (warmup
        "serve"), each run once eagerly at slot 0, cursor 0, on a zeroed
        table row (paged writes land on the trash page) and captured on
        cuda (a recurrent family's exact widths: built, not captured);
        the cursors, or the recurrent state, are restored after."""
        from repro_torch.analysis.serve_static import (
            enumerate_prefill_buckets)

        live = self._warmup_state()
        saved = [x.clone() for x in live]
        for cb in enumerate_prefill_buckets(
                max_len=self.cfg.max_len,
                prefill_chunk=self.cfg.prefill_chunk,
                bucketed=self._bucketed,
                page_size=self.cfg.page_size if self.paged else None,
                prefix_cache=self.prefix is not None):
            step = self._prefill_step_for(cb)
            if step.runs == 0:
                step.tokens.zero_()
                if step.cursor is not None:
                    step.cursor.zero_()
                if step.table is not None:
                    step.table.zero_()
                if step.slot is not None:
                    step.slot.zero_()
                step()
        for dst, src in zip(live, saved):
            dst.copy_(src)

    def _kernel_provenance(self) -> Dict[str, Any]:
        """JSON-safe kernel/plan provenance for trace attribution: the
        planner's backend and reason, whether the paged kernels run
        natively here, and which launch configuration each registry shape
        took and why.  Called only when tracing, at bucket rate."""
        plan = self.decode_plan
        out: Dict[str, Any] = {
            "backend": plan.backend if plan is not None else None,
            "plan_reason": plan.reason if plan is not None else None,
            "native": self.device.type in kops.NATIVE_PLATFORMS["paged"],
        }
        if kops.registry.decisions:
            out["decisions"] = {
                str(k): {"choice": str(v.get("choice")),
                         "source": v.get("source"),
                         "native": v.get("native")}
                for k, v in kops.registry.decisions.items()}
        return out

    # ---- prefill scheduling ----
    def _prefill_schedule(self, prompt_len: int,
                          start: int = 0) -> List[Tuple[int, int]]:
        return prefill_schedule(prompt_len, chunk=self.cfg.prefill_chunk,
                                max_len=self.cfg.max_len,
                                bucketed=self._bucketed, start=start)

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

    def _exec_chunks(self, slot: int, part: _PartialPrefill,
                     upto: int) -> Optional[Request]:
        """Run schedule chunks ``[part.next_chunk, upto)`` through the
        static prefill steps.  Between ticks the slot's cursor is pinned to
        the resume point ``pos``.  Returns the request when the batch
        completed the schedule and its first token was terminal."""
        req = part.req
        prompt = np.asarray(req.prompt, np.int32)
        L = len(prompt)
        tr = self.tel
        lo = part.next_chunk
        if part.paused:
            part.paused = False
            if tr is not None:
                tr.request_resumed(req.request_id, part.pos)
        # the chunk-batch X span starts AFTER the resumed instant: the X
        # event is emitted at its start timestamp
        t0 = tr.now() if tr is not None else 0.0
        step, last = None, 0
        last_i = len(part.schedule) - 1
        for i in range(part.next_chunk, upto):
            start, cb = part.schedule[i]
            real = min(start + cb, L) - start
            toks = np.zeros((1, cb), np.int32)
            toks[0, :real] = prompt[start:start + real]
            last = L - 1 - start if i == last_i else real - 1
            step = self._prefill_step_for(cb)
            step.tokens.copy_(torch.from_numpy(toks))  # sync: required — prompt-chunk upload (admission rate, not per tick)
            if step.cursor is not None:
                step.cursor.fill_(start)
            if self.paged:
                step.table.copy_(self.states.kv.block_tables[slot:slot + 1])
            if step.slot is not None:
                step.slot.fill_(slot)
            self.counters["prefill_chunks"] += 1
            if tr is not None:
                tr.begin("prefill_chunk", start=start, width=cb)
            step()
            if tr is not None:
                tr.end("prefill_chunk")
            # each schedule entry covers exactly min(chunk, L - pos) new
            # tokens (left-shifted windows rewrite, they don't advance)
            part.pos = min(part.pos + self.cfg.prefill_chunk, L)
            part.executed += 1
        part.next_chunk = upto
        self._progressed = True
        done = upto == len(part.schedule)
        if isinstance(self.states, LayerState):
            self._set_cursor(slot, L if done else part.pos)
        self.alloc.slots[slot].length = part.pos
        if tr is not None:
            tr.request_chunks(req.request_id, t0, lo, upto, part.pos,
                              len(part.schedule))
        if not done:
            log.debug("request %d prefilled to %d/%d tokens (chunk %d/%d)",
                      req.request_id, part.pos, L, part.next_chunk,
                      len(part.schedule))
            return None
        nxt = self._select(step.out[0, last][None])[0]
        part.last_tok = int(nxt)  # sync: required — prefill's first token feeds host-side finish/stream logic
        return self._complete_admission(slot, time.perf_counter())

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
        if self.tel is not None:
            self.tel.request_submit(req.request_id, plen,
                                    req.max_new_tokens, req.priority)

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
        if self.tel is not None:
            self.tel.instant("cow_fork", old_page=old, new_page=new)

    def _flush_tables(self, where: str = "decode"):
        """Mirror the host block tables into the device state in one
        batched host->device copy, when any row changed."""
        if not (self.paged and self._tables_dirty):
            return
        self.states.kv.block_tables.copy_(torch.from_numpy(self.alloc.block_tables))  # sync: required — the tick's one batched h2d block-table upload
        self._tables_dirty = False
        self.counters["table_uploads"] += 1
        self.counters[f"table_uploads_{where}"] += 1
        if self.tel is not None:
            self.tel.instant("table_upload", where=where)

    def _set_cursor(self, slot: int, value: int):
        """Device-side edit of one slot's cursor (no host transfer)."""
        self.states.kv.length[slot] = value

    def _reset_slot(self, slot: int, pos: int = 0):
        """Reset one slot's decode state across all layers before a chunk
        runs: the KV families pin the cursor at ``pos`` (rows past it are
        invalid by construction); a recurrent family zeroes the slot's
        rows of every state tensor, and the hybrid family the slot's
        Mamba carries, in place, so the decode graph's replays keep
        reading the same storage."""
        if isinstance(self.states, LayerState):
            self._set_cursor(slot, pos)
            if self._carries:
                self.states.ssm[:, slot].zero_()
                self.states.conv[:, slot].zero_()
            return
        for x in self.states:
            x[:, slot].zero_()

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

    def _prefill_quota(self) -> Optional[int]:
        """This tick's chunked-prefill token quota (None: unbounded), from
        the scheduler's token-budget policy.  A recurrent family prefills
        whole prompts: its carries would absorb the interleaved ticks' pad
        garbage, so the budget paces the KV families only."""
        if not self._bucketed:
            return None
        return self.scheduler.prefill_quota(self, len(self.active))

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

    def _append_token(self, req: Request, tok: int, now: float):
        """Record a generated token, stamp its latency sample at ``now``
        (the host clock just after the readback that delivered it), and
        fire the streaming callback."""
        tok = int(tok)  # sync: host — tok is a host int from the tick's one readback
        req.output.append(tok)
        self.counters["generated_tokens"] += 1
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
        if self.tel is not None:
            self.tel.request_decode(req.request_id, part.credit)
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
                     reserved_upto: Optional[int] = None
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
                    self._reset_slot(slot2)
                    if self.paged:
                        self._tables_dirty = True
                    if self.tel is not None:
                        self.tel.request_restaged(req.request_id)
                    return self._advance_one(slot2, quota, spent)
                self._prefill_stalled = True
                part.paused = True
                self.counters["paused_prefills"] += 1
                if self.tel is not None:
                    self.tel.request_paused(part.req.request_id, part.pos)
                log.debug("request %d paused mid-prefill at %d/%d tokens "
                          "(page pool dry)", part.req.request_id, part.pos,
                          len(part.req.prompt))
                return 0, None
        cost = self._batch_cost(part, upto)
        self._flush_tables("prefill")
        return cost, self._exec_chunks(slot, part, upto)

    def _run_prefills(self, quota: Optional[int]) -> List[Request]:
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
            cost, fin = self._advance_one(slot, quota, spent)
            spent += cost
            if fin is not None:
                finished.append(fin)
        tr = self.tel
        if tr is not None:
            tr.begin("scheduler", queued=len(self.scheduler))
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
            if tr is not None:
                tr.request_admitted(req.request_id, slot, part.credit,
                                    len(part.schedule))
            self._progressed = True
            # reset the slot's state; a credit-mounted partial pins its
            # cursor at the resume point right away, so its decode-tick
            # garbage write lands past the mount, never on a shared page
            self._reset_slot(slot, part.pos)
            if self.paged:
                self._tables_dirty = True
            cost, fin = self._advance_one(slot, quota, spent,
                                          reserved_upto=upto)
            spent += cost
            if fin is not None:
                finished.append(fin)
        if tr is not None:
            tr.end("scheduler")
        return finished

    def cancel(self, request_id: int) -> bool:
        """Abort a request wherever it lives (queued, mid-prefill or
        decoding).  False when the id is unknown."""
        for req in self.scheduler.pending():
            if req.request_id == request_id:
                self.scheduler.remove(req)
                req.truncated = True
                if self.tel is not None:
                    self.tel.request_cancel(request_id, "queued")
                return True
        for slot, part in list(self.admitting.items()):
            if part.req.request_id == request_id:
                del self.admitting[slot]
                self._unwind_slot(slot)
                part.req.truncated = True
                if self.tel is not None:
                    self.tel.request_cancel(request_id, "prefill")
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
        if self.tel is not None:
            self.tel.request_finish(
                req.request_id,
                "truncated" if req.truncated else "finish",
                len(req.output))
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
        tr = self.tel
        if tr is not None:
            tr.begin("tick", n=self._tick, active=len(self.active),
                     admitting=len(self.admitting),
                     queued=len(self.scheduler))
        finished: List[Request] = []
        for slot in list(self.active):
            req = self.active[slot]
            if self.alloc.slots[slot].length >= self.cfg.max_len or (
                    self.paged and not self._ensure_pages(
                        slot, self.alloc.slots[slot].length + 1)):
                req.truncated = True
                finished.append(self._finish(slot))
        if tr is not None:
            tr.begin("prefill_pass")
        finished.extend(self._run_prefills(self._prefill_quota()))
        if tr is not None:
            tr.end("prefill_pass")
        if not self.active:
            if tr is not None:
                tr.end("tick")
            return finished
        last = np.zeros((self.cfg.max_batch, 1), np.int32)
        for slot, req in self.active.items():
            last[slot, 0] = req.output[-1]
        if tr is not None:
            tr.begin("decode_step", batch=len(self.active))
        # the tick's one batched table upload, then the decode step of the
        # bucketed high-water table width (the kernel / gather then walks
        # only pages a row can hold): built, run eagerly and captured at
        # the bucket's first tick, replayed after
        self._flush_tables("decode")
        width = self._decode_table_width() if self.paged else "contiguous"
        first = width not in self._decode_steps
        step = self._decode_step_for(width)
        step.tokens.copy_(torch.from_numpy(last))  # sync: required — the tick's last-token batch upload
        step()
        if first and self.paged and tr is not None:
            # first tick at this table width: kernel/plan provenance (the
            # launch configuration the registry just timed) on the trace
            tr.instant("decode_bucket", cat="plan", table_width=width,
                       **self._kernel_provenance())
        self.counters["decode_ticks"] += 1
        if self.admitting and self._bucketed:
            # mid-prefill rows rode this tick as inactive rows: re-pin
            # their cursors at the resume point
            for slot, part in self.admitting.items():
                self._set_cursor(slot, part.pos)
        self._progressed = True
        nxt = self._select(step.out).tolist()  # sync: required — the tick's one d2h readback (next tokens drive host finish logic)
        now = time.perf_counter()
        if tr is not None:
            tr.end("decode_step")
            tr.begin("emit")
        for slot in list(self.active):
            req = self.active[slot]
            self._append_token(req, nxt[slot], now)
            self.alloc.slots[slot].length += 1
            if (len(req.output) >= req.max_new_tokens
                    or (req.eos_id is not None
                        and req.output[-1] == req.eos_id)):
                finished.append(self._finish(slot))
        if tr is not None:
            tr.end("emit")
            tr.end("tick")
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
        admission backed off or a prefill stalled).  ``on_tick(engine,
        finished)`` runs after every tick (the launcher's ``--log-json``
        hook).  At drain the compile counts are checked against the
        proven budget."""
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
                raise RuntimeError(self._dump_on_error(
                    f"engine cannot make progress: {len(self.scheduler)} "
                    f"request(s) queued (head: {head_desc}), "
                    f"{len(self.admitting)} mid-prefill, no active "
                    f"slots, and admission backed off or stalled"
                    + (f" [pages_in_use={self.alloc.pages_in_use}/"
                       f"{self.alloc.num_pages - 1}]" if self.paged else
                       "")))
        self._check_compile_soundness()
        return done

    def _dump_on_error(self, msg: str) -> str:
        """Flight-recorder hook for engine error paths: dump the last K
        events and append the dump path to the error message (telemetry
        off: the message passes through untouched)."""
        if self.tel is None or self.tel.ring is None:
            return msg
        path = dump_flight(self.tel, msg)
        log.error("flight recorder dumped to %s", path)
        return f"{msg} [flight recorder: {path}]"

    def _check_compile_soundness(self) -> None:
        """Measured-vs-proven compile check at drain: more static steps
        than the proven retrace budget means the static enumeration
        missed a reachable bucket — raise, with the flight recorder
        dumped."""
        b = self.retrace_budget()
        pm, dm = self.prefill_compiles, self.decode_compiles
        if pm <= b["prefill_proven"] and dm <= b["decode_proven"]:
            return
        raise RuntimeError(self._dump_on_error(
            f"SOUNDNESS BUG: measured compiles exceed the proven retrace "
            f"budget (prefill {pm}/{b['prefill_proven']}, decode "
            f"{dm}/{b['decode_proven']}) — the static enumeration missed "
            f"a reachable step bucket"))
