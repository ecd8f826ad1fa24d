"""Serve-path telemetry: span tracer, flight recorder, metrics registry.

Port of :mod:`repro.serve.telemetry`, host-only and allocation-bounded:

  * **Tracer** — the event bus the engine threads through its tick
    loop.  Every request gets a lifecycle span tree on its own Perfetto
    track (submit → queued → admitted[prefix credit] → prefill chunk
    batches [paused/resumed] → decode → finish/cancel/truncated); every
    engine tick gets phase attribution on track 0 (prefill pass,
    scheduler, decode step) plus instants for table uploads, CoW forks,
    evictions, and first-seen decode buckets (with kernel/plan
    provenance attached as args).  Events are 6-tuples appended to a
    plain list — no objects, no I/O — and the same append feeds a
    bounded ``deque`` ring (the flight recorder).  Timestamps are host
    ``time.perf_counter`` readings, never device events, so a trace says
    when the host issued work, not when the card ran it;
    ``Tracer.origin`` is the ``perf_counter`` reading at timestamp 0.
    Each engine-track span is mirrored as a ``torch.profiler`` range
    named ``repro_torch.serve.<span>`` (its only ``torch`` call, two
    dispatcher calls a span and no transfer), so that a profiler trace
    attributes device time to the tick's phases; request spans, which
    cross ticks and do not nest, are not.
  * **Flight recorder** — the last ``ring`` events, dumped to JSON by
    the engine's error paths (:func:`dump_flight`).
  * **MetricsRegistry** — the engine's counters plus bounded reservoir
    :class:`Histogram` s (Vitter's algorithm R).

The events, the Chrome trace export and the validator keep the
reference's schema, so each package's validator accepts the other's
traces.  The engine holds ``self.tel = None`` when telemetry is off and
guards every hook with one ``is not None`` test.  The host-sync audit
(``repro_torch.analysis.serve_static.audit_telemetry_file``) closes the
call graph over the emit-path functions below and finds no
host<->device transfer on it.

CLI — validate and summarize a trace (exit 1 when malformed: unbalanced
or misnested B/E spans, per-track timestamps going backwards, a request
span without exactly one terminal event)::

    python -m repro_torch.serve.telemetry TRACE_serve.json
"""

from __future__ import annotations

import dataclasses
import json
import random
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

SCHEMA = 1

#: single-process trace: every event shares one pid
PID = 1
#: track 0 is the engine tick timeline; request lifecycles get their own
#: track at REQ_TID_BASE + request_id so Perfetto renders one swimlane
#: per request under the tick timeline
TID_ENGINE = 0
REQ_TID_BASE = 1000

#: terminal request states (exactly one instant per request track)
TERMINALS = ("finish", "cancel", "truncated")

#: an engine-track span ``name`` is mirrored as the profiler range
#: RANGE_PREFIX + name
RANGE_PREFIX = "repro_torch.serve."

__all__ = [
    "SCHEMA", "PID", "TID_ENGINE", "REQ_TID_BASE", "TERMINALS",
    "RANGE_PREFIX",
    "Histogram", "MetricsRegistry", "TelemetryConfig", "Tracer",
    "make_tracer", "to_chrome_trace", "write_trace", "dump_flight",
    "validate_chrome_trace", "summarize_chrome_trace", "main",
]


# --------------------------------------------------------------------------
# metrics registry: counters + bounded reservoir histograms
# --------------------------------------------------------------------------

class Histogram:
    """Fixed-capacity reservoir sample (Vitter's algorithm R) with exact
    count/min/max/sum.  Replaces the engine's unbounded latency lists:
    ``record`` is O(1), percentiles are computed over at most
    ``capacity`` values, and memory never grows with serve time.  The
    reservoir RNG is private and deterministically seeded — recording
    never perturbs ``random``'s global state or torch generators."""

    __slots__ = ("capacity", "count", "total", "vmin", "vmax",
                 "_vals", "_rng")

    def __init__(self, capacity: int = 512, seed: int = 0x5EED):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.count = 0
        self.total = 0.0
        self.vmin = 0.0
        self.vmax = 0.0
        self._vals: List[float] = []
        self._rng = random.Random(seed)

    def record(self, v) -> None:
        v = float(v)  # sync: host — latency samples arrive as host scalars (the engine reads device values upstream, under its own audited tag)
        self.count += 1
        self.total += v
        if self.count == 1 or v < self.vmin:
            self.vmin = v
        if self.count == 1 or v > self.vmax:
            self.vmax = v
        if len(self._vals) < self.capacity:
            self._vals.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self._vals[j] = v

    @property
    def max(self) -> float:
        return self.vmax

    @property
    def min(self) -> float:
        return self.vmin

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def __len__(self) -> int:
        return self.count

    def percentile(self, p: float) -> float:
        """Percentile over the reservoir (the exact percentile while
        ``count <= capacity``; an unbiased estimate after)."""
        if not self._vals:
            return 0.0
        return float(np.percentile(self._vals, p))  # sync: host — the reservoir is host-resident python floats

    def snapshot(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "mean": round(self.mean, 4),
            "min": round(self.vmin, 4),
            "max": round(self.vmax, 4),
            "p50": round(self.percentile(50), 4),
            "p99": round(self.percentile(99), 4),
            "reservoir": len(self._vals),
            "capacity": self.capacity,
        }


class MetricsRegistry:
    """One home for the engine's scalar counters and bounded histograms.
    ``Engine.counters`` aliases ``self.counters`` so every existing
    counter key keeps working; histograms back ``Engine.stats()``'s
    ``*_p50`` / ``*_p99`` / ``latency_samples`` surface."""

    def __init__(self):
        self.counters: Dict[str, int] = {}
        self.histograms: Dict[str, Histogram] = {}

    def histogram(self, name: str, capacity: int = 512) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(capacity)
        return h

    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": dict(self.counters),
            "histograms": {k: h.snapshot()
                           for k, h in sorted(self.histograms.items())},
        }


# --------------------------------------------------------------------------
# tracer + flight-recorder ring
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TelemetryConfig:
    """Telemetry spec for ``EngineConfig.telemetry``.  ``trace=False``
    keeps only the flight-recorder ring (crash forensics with O(ring)
    memory); ``ring=0`` disables the ring."""
    trace: bool = True
    ring: int = 256
    flight_path: str = "FLIGHT_serve.json"


class Tracer:
    """Append-only span/event recorder.  An event is the 6-tuple
    ``(ts_us, ph, name, cat, tid, args)`` — ``ph`` is the Chrome
    trace-event phase (B/E/i/X).  Emission is two list appends at
    most; export/validation cost is paid only when a trace is written.

    The ``request_*`` helpers encode the lifecycle span grammar in ONE
    place so the engine call sites stay single guarded lines and the
    validator can rely on the nesting:

        B request > B queued .. E queued > i admitted > B prefill
        [X prefill_chunks / i paused / i resumed / i restaged_uncached]*
        .. E prefill > B decode .. E decode > i finish|cancel|truncated
        > E request
    """

    def __init__(self, *, trace: bool = True, ring: int = 256,
                 flight_path: str = "FLIGHT_serve.json"):
        self.events: Optional[List[tuple]] = [] if trace else None
        self.ring: Optional[deque] = (deque(maxlen=ring) if ring > 0
                                      else None)
        self.flight_path = flight_path
        self.dropped = 0           # events evicted from the ring
        self.meta: Dict[str, Any] = {}
        self.thread_names: Dict[int, str] = {TID_ENGINE: "engine ticks"}
        # the open engine-track spans' profiler ranges, innermost last
        self._ranges: List[torch.profiler.record_function] = []
        #: ``time.perf_counter()`` at timestamp 0: an event at ``ts`` µs
        #: happened at ``origin + ts * 1e-6`` on the host's clock
        self.origin = time.perf_counter()

    # ---- core emit path (audited: zero host<->device transfers) ----
    def now(self) -> float:
        """Microseconds since tracer construction (trace timebase)."""
        return (time.perf_counter() - self.origin) * 1e6

    def _emit(self, ts: Optional[float], ph: str, name: str, cat: str,
              tid: int, args: Optional[Dict[str, Any]]) -> None:
        ev = (self.now() if ts is None else ts, ph, name, cat, tid, args)
        ring = self.ring
        if ring is not None:
            if len(ring) == ring.maxlen:
                self.dropped += 1
            ring.append(ev)
        if self.events is not None:
            self.events.append(ev)

    def begin(self, name: str, tid: int = TID_ENGINE, cat: str = "tick",
              **args) -> None:
        self._emit(None, "B", name, cat, tid, args or None)
        if tid == TID_ENGINE:
            rng = torch.profiler.record_function(RANGE_PREFIX + name)
            rng.__enter__()
            self._ranges.append(rng)

    def end(self, name: str, tid: int = TID_ENGINE) -> None:
        if tid == TID_ENGINE and self._ranges:
            self._ranges.pop().__exit__(None, None, None)
        self._emit(None, "E", name, "", tid, None)

    def instant(self, name: str, tid: int = TID_ENGINE, cat: str = "tick",
                **args) -> None:
        self._emit(None, "i", name, cat, tid, args or None)

    def complete(self, name: str, start: float, tid: int = TID_ENGINE,
                 cat: str = "tick", **args) -> None:
        """X event spanning [start, now) — ``start`` from :meth:`now`."""
        args["_dur"] = self.now() - start
        self._emit(start, "X", name, cat, tid, args)

    def set_meta(self, key: str, value: Any) -> None:
        """Trace-level metadata (plan/kernel provenance, engine config);
        exported under ``otherData.meta``, JSON-serializable values."""
        self.meta[key] = value

    def set_thread_name(self, tid: int, label: str) -> None:
        self.thread_names[tid] = label

    # ---- request lifecycle grammar ----
    def request_submit(self, rid: int, prompt_len: int,
                       max_new_tokens: int, priority: int) -> None:
        tid = REQ_TID_BASE + rid
        self.thread_names[tid] = f"req {rid}"
        self.begin("request", tid=tid, cat="request", id=rid,
                   prompt_len=prompt_len, max_new_tokens=max_new_tokens,
                   priority=priority)
        self.begin("queued", tid=tid, cat="request")

    def request_admitted(self, rid: int, slot: int, credit: int,
                         chunks: int) -> None:
        tid = REQ_TID_BASE + rid
        self.end("queued", tid=tid)
        self.instant("admitted", tid=tid, cat="request", slot=slot,
                     prefix_credit=credit, chunks=chunks)
        self.begin("prefill", tid=tid, cat="request", prefix_credit=credit)

    def request_chunks(self, rid: int, start: float, lo: int, hi: int,
                       pos: int, total: int) -> None:
        self.complete("prefill_chunks", start, tid=REQ_TID_BASE + rid,
                      cat="request", lo=lo, hi=hi, pos=pos, total=total)

    def request_paused(self, rid: int, pos: int) -> None:
        self.instant("paused", tid=REQ_TID_BASE + rid, cat="request",
                     pos=pos)

    def request_resumed(self, rid: int, pos: int) -> None:
        self.instant("resumed", tid=REQ_TID_BASE + rid, cat="request",
                     pos=pos)

    def request_restaged(self, rid: int) -> None:
        self.instant("restaged_uncached", tid=REQ_TID_BASE + rid,
                     cat="request")

    def request_decode(self, rid: int, credit: int) -> None:
        tid = REQ_TID_BASE + rid
        self.end("prefill", tid=tid)
        self.begin("decode", tid=tid, cat="request", prefix_credit=credit)

    def request_finish(self, rid: int, terminal: str, tokens: int) -> None:
        tid = REQ_TID_BASE + rid
        self.end("decode", tid=tid)
        self.instant(terminal, tid=tid, cat="request", tokens=tokens)
        self.end("request", tid=tid)

    def request_cancel(self, rid: int, where: str) -> None:
        """Cancel before decode: ``where`` is 'queued' or 'prefill' (an
        actively decoding cancel goes through the finish path as
        ``truncated`` instead)."""
        tid = REQ_TID_BASE + rid
        self.end("queued" if where == "queued" else "prefill", tid=tid)
        self.instant("cancel", tid=tid, cat="request", where=where)
        self.end("request", tid=tid)


def make_tracer(spec) -> Optional[Tracer]:
    """``EngineConfig.telemetry`` -> Tracer or None (disabled).

    ``None``/``False`` -> disabled (the zero-overhead default);
    ``True``/``"on"`` -> full tracing; ``"flight"`` -> flight-recorder
    ring only (no event list); a :class:`TelemetryConfig` or an existing
    :class:`Tracer` pass through."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, Tracer):
        return spec
    if spec is True or spec == "on":
        return Tracer()
    if spec == "flight":
        return Tracer(trace=False)
    if isinstance(spec, TelemetryConfig):
        return Tracer(trace=spec.trace, ring=spec.ring,
                      flight_path=spec.flight_path)
    raise ValueError(f"unknown telemetry spec {spec!r} (expected None, "
                     f"bool, 'on', 'flight', TelemetryConfig, or Tracer)")


# --------------------------------------------------------------------------
# Chrome trace-event export (Perfetto-loadable)
# --------------------------------------------------------------------------

def _event_dict(ev: tuple) -> Dict[str, Any]:
    ts, ph, name, cat, tid, args = ev
    d: Dict[str, Any] = {"name": name, "ph": ph, "ts": round(ts, 3),
                         "pid": PID, "tid": tid}
    if cat:
        d["cat"] = cat
    if args:
        args = dict(args)
        dur = args.pop("_dur", None)
        if dur is not None:
            d["dur"] = round(dur, 3)
        if args:
            d["args"] = args
    if ph == "i":
        d["s"] = "t"               # thread-scoped instant
    return d


def to_chrome_trace(tracer: Tracer) -> Dict[str, Any]:
    """Full-trace export: metadata events name the tracks (engine ticks
    on top, one swimlane per request), then the event stream in emission
    order."""
    evs: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "ts": 0, "pid": PID,
         "tid": TID_ENGINE, "args": {"name": "repro_torch.serve.engine"}},
    ]
    for tid, label in sorted(tracer.thread_names.items()):
        evs.append({"name": "thread_name", "ph": "M", "ts": 0, "pid": PID,
                    "tid": tid, "args": {"name": label}})
        evs.append({"name": "thread_sort_index", "ph": "M", "ts": 0,
                    "pid": PID, "tid": tid, "args": {"sort_index": tid}})
    evs.extend(_event_dict(ev) for ev in (tracer.events or ()))
    return {
        "traceEvents": evs,
        "displayTimeUnit": "ms",
        "otherData": {"schema": SCHEMA, "flight": False,
                      "dropped": tracer.dropped, "meta": tracer.meta},
    }


def write_trace(tracer: Tracer, path) -> str:
    p = Path(path)
    p.write_text(json.dumps(to_chrome_trace(tracer), indent=1,
                            sort_keys=True), encoding="utf-8")
    return str(p)


def dump_flight(tracer: Tracer, reason: str, path=None) -> str:
    """Write the flight-recorder ring (last K events before an engine
    error) as a relaxed Chrome trace: Perfetto still loads it, and the
    validator skips span-balance checks (``otherData.flight``) since the
    ring may open mid-span."""
    p = Path(path if path is not None else tracer.flight_path)
    doc = {
        "traceEvents": [_event_dict(ev) for ev in (tracer.ring or ())],
        "displayTimeUnit": "ms",
        "otherData": {"schema": SCHEMA, "flight": True, "reason": reason,
                      "dropped": tracer.dropped, "meta": tracer.meta},
    }
    p.write_text(json.dumps(doc, indent=1, sort_keys=True),
                 encoding="utf-8")
    return str(p)


# --------------------------------------------------------------------------
# validation + summary (the CLI's hard gate)
# --------------------------------------------------------------------------

_VALID_PH = frozenset({"B", "E", "i", "X", "C", "M"})


def validate_chrome_trace(doc: Dict[str, Any],
                          flight: Optional[bool] = None) -> Dict[str, Any]:
    """Schema + well-formedness check of a Chrome trace-event document.

    Hard requirements (full traces): every event carries name/ph/ts/
    pid/tid with sane types; per-track timestamps are non-decreasing;
    B/E spans balance and nest (E matches the innermost open B on its
    track); every request track reaches exactly one terminal instant
    (finish/cancel/truncated) and closes its root span.  Flight dumps
    (``otherData.flight`` or ``flight=True``) relax the balance and
    terminal requirements — the ring legitimately starts mid-span."""
    errors: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return {"ok": False, "errors": ["traceEvents is not a list"],
                "summary": {}}
    if flight is None:
        flight = bool(doc.get("otherData", {}).get("flight"))
    stacks: Dict[int, List[str]] = {}
    last_ts: Dict[int, float] = {}
    request_tracks: set = set()
    admitted: set = set()
    terminals: Dict[int, List[str]] = {}
    n_by_ph: Dict[str, int] = {}
    ticks = 0
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            errors.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        name = e.get("name")
        if ph not in _VALID_PH:
            errors.append(f"event {i}: bad ph {ph!r}")
            continue
        n_by_ph[ph] = n_by_ph.get(ph, 0) + 1
        if not isinstance(name, str):
            errors.append(f"event {i}: name is not a string")
            continue
        if not isinstance(e.get("ts"), (int, float)):
            errors.append(f"event {i} ({name}): ts is not a number")
            continue
        if not isinstance(e.get("pid"), int) or not isinstance(
                e.get("tid"), int):
            errors.append(f"event {i} ({name}): pid/tid not ints")
            continue
        if ph == "M":
            continue
        tid, ts = e["tid"], e["ts"]
        if ts < last_ts.get(tid, 0.0) - 1e-6:
            errors.append(f"event {i} ({name}): ts {ts} goes backwards "
                          f"on track {tid}")
        last_ts[tid] = max(last_ts.get(tid, 0.0), ts)
        if ph == "X" and not isinstance(e.get("dur"), (int, float)):
            errors.append(f"event {i} ({name}): X event without dur")
        if ph == "B":
            stacks.setdefault(tid, []).append(name)
            if name == "tick":
                ticks += 1
            if name == "request":
                request_tracks.add(tid)
        elif ph == "E":
            stack = stacks.setdefault(tid, [])
            if not stack:
                if not flight:
                    errors.append(f"event {i}: E {name!r} with no open "
                                  f"span on track {tid}")
            elif stack[-1] != name:
                errors.append(f"event {i}: E {name!r} does not match "
                              f"innermost open span {stack[-1]!r} on "
                              f"track {tid}")
                stack.pop()
            else:
                stack.pop()
        elif ph == "i":
            if name == "admitted":
                admitted.add(tid)
            if name in TERMINALS:
                terminals.setdefault(tid, []).append(name)
    if not flight:
        for tid, stack in sorted(stacks.items()):
            if stack:
                errors.append(f"track {tid}: unclosed span(s) {stack}")
        for tid in sorted(request_tracks):
            t = terminals.get(tid, [])
            if len(t) != 1:
                errors.append(
                    f"request track {tid}: expected exactly one terminal "
                    f"event ({'/'.join(TERMINALS)}), got {t}")
        for tid in sorted(admitted - request_tracks):
            errors.append(f"track {tid}: 'admitted' without a request "
                          f"root span")
    term_counts: Dict[str, int] = {}
    for names in terminals.values():
        for n in names:
            term_counts[n] = term_counts.get(n, 0) + 1
    all_ts = [e["ts"] for e in evs
              if isinstance(e, dict) and e.get("ph") != "M"
              and isinstance(e.get("ts"), (int, float))]
    summary = {
        "events": len(evs),
        "by_ph": n_by_ph,
        "ticks": ticks,
        "requests": len(request_tracks),
        "admitted": len(admitted),
        "terminals": term_counts,
        "wall_ms": round((max(all_ts) - min(all_ts)) / 1e3, 3)
        if all_ts else 0.0,
        "flight": flight,
    }
    return {"ok": not errors, "errors": errors[:50], "summary": summary}


def summarize_chrome_trace(doc: Dict[str, Any]) -> str:
    v = validate_chrome_trace(doc)
    s = v["summary"]
    other = doc.get("otherData", {}) if isinstance(doc, dict) else {}
    lines = [
        f"trace: {s.get('events', 0)} events over "
        f"{s.get('wall_ms', 0.0)} ms"
        + (" [flight-recorder dump]" if s.get("flight") else ""),
        f"  ticks={s.get('ticks', 0)} requests={s.get('requests', 0)} "
        f"admitted={s.get('admitted', 0)} "
        f"terminals={s.get('terminals', {})}",
        f"  phases={s.get('by_ph', {})} "
        f"dropped_from_ring={other.get('dropped', 0)}",
    ]
    if other.get("reason"):
        lines.append(f"  dump reason: {other['reason']}")
    meta = other.get("meta") or {}
    if meta.get("decode_plan"):
        p = meta["decode_plan"]
        lines.append(f"  decode plan: backend={p.get('backend')} "
                     f"({p.get('reason', '')[:80]})")
    lines.append(f"  => {'VALID' if v['ok'] else 'INVALID'}")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve.telemetry",
        description="Validate + summarize a serve-path Chrome trace "
                    "(or flight-recorder dump); exit 1 when malformed")
    ap.add_argument("trace", help="trace JSON (from --trace-out or a "
                                  "FLIGHT_serve.json dump)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the summary, report errors only")
    args = ap.parse_args(argv)

    with open(args.trace, encoding="utf-8") as f:
        doc = json.load(f)
    v = validate_chrome_trace(doc)
    if not args.quiet:
        print(summarize_chrome_trace(doc))
    for err in v["errors"]:
        print(f"TRACE INVALID: {err}", file=sys.stderr)
    return 0 if v["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
