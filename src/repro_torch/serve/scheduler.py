"""Pluggable request schedulers for the serving engine (port of
:mod:`repro.serve.scheduler`) (DESIGN.md §11).

The engine's admission loop used to be a hardcoded FIFO ``deque``; the
``Scheduler`` protocol makes the admission *order* a policy:

``fifo``
    Arrival order (the old behavior, and the default).
``priority``
    Highest ``Request.priority`` first, FIFO within a priority level.
``prefix``
    Prefix affinity: prefer the queued request whose prompt has the
    longest prefix already resident in the engine's radix index
    (``serve.prefix.PrefixIndex``) — admitting it now costs the fewest
    prefill tokens and keeps hot prefixes hot.  Ties (including the
    all-miss case, and engines without a prefix cache) fall back to
    arrival order.  Affinity probes use ``touch=False`` so peeking at
    the index does not distort its LRU eviction order.

Protocol contract: ``next(engine)`` *peeks* — it returns the request the
policy would admit now without removing it, so the engine can back off
(pool dry, no free slot) and retry the same choice next tick; the engine
calls ``remove(req)`` once the request is actually admitted.  Policies
are registered by name (``register_scheduler``) and resolved by
``make_scheduler``, which also accepts a ready-made instance, so a custom
policy is a leaf change — no engine edits.

Continuous batching (DESIGN.md §15): ``prefill_quota(engine,
decode_slots)`` is the **token-budget-per-tick policy** — each engine
tick asks the scheduler how many prompt tokens chunked prefill may
execute this tick, given that ``decode_slots`` active requests will each
decode one token.  The default (decode-first: ``tick_budget`` minus the
decode slots, unbounded when ``EngineConfig.tick_budget`` is None) is
inherited by every policy here, so admission *order* and tick *budget*
compose independently; a custom policy can return 0 to defer prefill
entirely — the engine treats that as a scheduling choice, not a stuck
engine.

Starvation: ``priority`` and ``prefix`` are deliberately simple (no
aging); a starving workload should submit with adjusted priorities or
pick ``fifo``.
"""

from __future__ import annotations

from collections import deque
from typing import (Callable, Dict, List, Optional, Protocol, Union,
                    runtime_checkable)


@runtime_checkable
class Scheduler(Protocol):
    """Admission-order policy over submitted-but-not-admitted requests."""

    def add(self, req) -> None:
        """Enqueue a newly submitted request."""

    def next(self, engine) -> Optional["object"]:
        """The request the policy would admit now (peek, no removal), or
        None when empty.  ``engine`` grants read access to residency
        state (e.g. ``engine.prefix``)."""

    def remove(self, req) -> None:
        """Drop an admitted (or cancelled) request from the queue."""

    def pending(self) -> List["object"]:
        """Queued requests, in arrival order."""

    def prefill_quota(self, engine, decode_slots: int) -> Optional[int]:
        """Prompt-token budget for this tick's chunked prefill (None =
        unbounded — prefill whole prompts at admission).  ``decode_slots``
        is the number of active requests that will decode one token each
        this tick; the budget charges prefill by *padded* chunk widths
        (the tokens the prefill step actually executes)."""

    def __len__(self) -> int:
        ...


class FIFOScheduler:
    """Arrival order — the engine's original hardcoded policy."""

    name = "fifo"

    def __init__(self):
        self._q: deque = deque()

    def add(self, req) -> None:
        self._q.append(req)

    def next(self, engine) -> Optional[object]:
        return self._q[0] if self._q else None

    def prefill_quota(self, engine, decode_slots: int) -> Optional[int]:
        """Default token-budget policy (inherited by every registered
        scheduler): decode gets first claim on the tick budget — each
        active slot produces exactly one token per tick — and chunked
        prefill spends what is left.  ``tick_budget=None`` keeps the
        legacy whole-prompt admission (unbounded prefill per tick)."""
        budget = engine.cfg.tick_budget
        if budget is None:
            return None
        return max(0, budget - decode_slots)

    def remove(self, req) -> None:
        self._q.remove(req)

    def pending(self) -> List[object]:
        return list(self._q)

    def __len__(self) -> int:
        return len(self._q)


class PriorityScheduler(FIFOScheduler):
    """Highest ``Request.priority`` first; FIFO within a level."""

    name = "priority"

    def next(self, engine) -> Optional[object]:
        if not self._q:
            return None
        # Request.arrival (stamped at submit) breaks priority ties FIFO
        return max(self._q, key=lambda r: (getattr(r, "priority", 0),
                                           -getattr(r, "arrival", 0)))


class PrefixAffinityScheduler(FIFOScheduler):
    """Longest-resident-prefix first (falls back to FIFO on all-miss or
    when the engine has no prefix index)."""

    name = "prefix"

    def next(self, engine) -> Optional[object]:
        if not self._q:
            return None
        index = getattr(engine, "prefix", None)
        if index is None or not index.root.children:
            return self._q[0]              # no index / cold cache: FIFO
        # Request.arrival breaks resident-length ties FIFO.  Probes are
        # O(queue * prompt_len) per peek — fine at engine queue depths;
        # a custom policy can memoize per-request keys if it must scale
        return max(self._q,
                   key=lambda r: (index.match(r.prompt, touch=False)[0],
                                  -getattr(r, "arrival", 0)))


SCHEDULERS: Dict[str, Callable[[], Scheduler]] = {}


def register_scheduler(name: str, factory: Callable[[], Scheduler]):
    SCHEDULERS[name] = factory


register_scheduler("fifo", FIFOScheduler)
register_scheduler("priority", PriorityScheduler)
register_scheduler("prefix", PrefixAffinityScheduler)


def make_scheduler(spec: Union[str, Scheduler, None]) -> Scheduler:
    """Resolve a scheduler: a registered name, a ready-made instance, or
    None (-> fifo)."""
    if spec is None:
        return FIFOScheduler()
    if isinstance(spec, str):
        try:
            return SCHEDULERS[spec]()
        except KeyError:
            raise ValueError(
                f"unknown scheduler {spec!r}; registered: "
                f"{sorted(SCHEDULERS)}") from None
    if isinstance(spec, Scheduler):
        return spec
    raise TypeError(f"scheduler must be a name or Scheduler, got "
                    f"{type(spec).__name__}")
