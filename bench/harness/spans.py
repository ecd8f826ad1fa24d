"""What the per-layer metrics that read the program's own spans read, and
the splits ``bench/split.py`` prints.

The program records ``torch.profiler`` ranges inside itself: the train
step's ``repro_torch.train.forward`` / ``.backward`` / ``.optimizer``
(``repro_torch/train/step.py``) and, while the engine's telemetry is on,
its tick phases as ``repro_torch.serve.<span>`` (``tick``,
``prefill_pass``, ``scheduler``, ``prefill_chunk``, ``decode_step``,
``emit``; ``repro_torch/serve/telemetry.py``).  Device time is attributed
to a range as ``harness.trace`` does: by the runtime calls made inside
it, and only complete ranges count.  The engine's request spans
(``queued``: submit to admission; ``prefill``: admission to first token)
are on its tracer's host clock, ``Tracer.origin`` plus the event's µs,
and are paired by (track, name).  A reader returns None where it finds
nothing to read, never 0: a program without the ranges reads None.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

TRAIN_RANGES = ("repro_torch.train.forward", "repro_torch.train.backward",
                "repro_torch.train.optimizer")
PREFILL_CHUNK = "repro_torch.serve.prefill_chunk"
# the first request track (``serve.telemetry.REQ_TID_BASE``); the engine's
# ticks are on track 0
REQ_TID_BASE = 1000


def _device_ms(trace, lo: float, hi: float) -> float:
    return sum(float(e["dur"]) for e in trace.records_in(lo, hi)) * 1e-3


def train_range_ms(r, name: str) -> Optional[float]:
    """Device ms a traced step spends under the program's ranges
    ``name``, over the complete ``bench.train_step`` ranges."""
    if r.trace is None:
        return None
    steps = [(lo, hi) for lo, hi in r.trace.ranges("bench.train_step")
             if r.trace.complete(lo, hi)]
    inner = [(a, b) for a, b in r.trace.ranges(name)
             if any(lo <= a and b <= hi for lo, hi in steps)]
    if not inner:
        return None
    return sum(_device_ms(r.trace, a, b) for a, b in inner) / len(steps)


def forward_device_ms(r) -> Optional[float]:
    return train_range_ms(r, TRAIN_RANGES[0])


def optimizer_device_ms(r) -> Optional[float]:
    return train_range_ms(r, TRAIN_RANGES[2])


def prefill_chunk_device_ms(r) -> Optional[float]:
    """Device ms of one prefill chunk's step: the mean over the complete
    ``repro_torch.serve.prefill_chunk`` ranges of the traced ticks."""
    if r.trace is None:
        return None
    chunks = [(a, b) for a, b in r.trace.ranges(PREFILL_CHUNK)
              if r.trace.complete(a, b)]
    if not chunks:
        return None
    return sum(_device_ms(r.trace, a, b) for a, b in chunks) / len(chunks)


# ---------------------------------------------------------------------------
# the engine's request spans
# ---------------------------------------------------------------------------

def request_spans(events: Iterable[tuple], name: str,
                  origin: float) -> Dict[int, Tuple[float, float]]:
    """{request id: (begin, end)} of each request's span ``name``, in
    host seconds, from the tracer's events paired by (track, name)."""
    open_: Dict[int, float] = {}
    out = {}
    for ts, ph, n, _cat, tid, _args in events:
        if n != name or tid < REQ_TID_BASE:
            continue
        if ph == "B":
            open_[tid] = ts
        elif ph == "E" and tid in open_:
            out[tid - REQ_TID_BASE] = (origin + open_.pop(tid) * 1e-6,
                                       origin + ts * 1e-6)
    return out


def mean_span_ms(events: Iterable[tuple], name: str, origin: float,
                 lo: float, hi: float) -> Optional[float]:
    """Mean ms of the request spans ``name`` that end in [lo, hi): of
    ``queued``, the requests admitted in the window; of ``prefill``,
    those whose first token came in it."""
    ms = [(b - a) * 1e3 for a, b in request_spans(events, name,
                                                  origin).values()
          if lo <= b < hi]
    return sum(ms) / len(ms) if ms else None


def ttft_split(timeline, events: List[tuple], origin: float, lo: float,
               hi: float) -> Optional[dict]:
    """The TTFT of each request due in [lo, hi) and served by ``hi``,
    split into the harness's submit lag (due to the engine's ``queued``
    span), ``queued``, ``prefill`` and the rest (the first token's
    callback after the span closed), in ms: the means over those
    requests, and over those at or beyond the p90 of every TTFT due in
    the window (the harness's ``ttft_p90_ms``, unserved requests
    counting their wait); beside them the mean of every TTFT due in the
    window, unserved ones counting their wait."""
    from harness.stats import percentile

    queued = request_spans(events, "queued", origin)
    prefill = request_spans(events, "prefill", origin)
    rows = []
    for rid, due in timeline.due.items():
        toks = timeline.tokens[rid]
        if not (lo <= due < hi and toks and toks[0] <= hi
                and rid in queued and rid in prefill):
            continue
        (q0, q1), (p0, p1) = queued[rid], prefill[rid]
        ttft = (toks[0] - due) * 1e3
        parts = {"submit_lag": (q0 - due) * 1e3, "queued": (q1 - q0) * 1e3,
                 "prefill": (p1 - p0) * 1e3}
        parts["rest"] = ttft - sum(parts.values())
        rows.append((ttft, parts))
    if not rows:
        return None
    waits = timeline.ttft_ms(lo, hi)
    p90 = percentile(waits, 90)

    def means(sel):
        if not sel:
            return None
        out = {k: sum(p[k] for _t, p in sel) / len(sel) for k in sel[0][1]}
        out["ttft"] = sum(t for t, _p in sel) / len(sel)
        out["n"] = len(sel)
        return out

    return {"ttft_mean_ms": sum(waits) / len(waits), "ttft_p90_ms": p90,
            "mean": means(rows),
            "at_or_beyond_p90": means([x for x in rows if x[0] >= p90]),
            "ttft_queued_ms": mean_span_ms(events, "queued", origin, lo, hi),
            "ttft_prefill_ms": mean_span_ms(events, "prefill", origin, lo,
                                            hi)}


# ---------------------------------------------------------------------------
# the traced slice by range (``bench/split.py``; the idle time by range is
# the breakdown's ``idle_gaps``)
# ---------------------------------------------------------------------------

#: the program's own ranges, by their names' prefix
PROGRAM_PREFIX = "repro_torch."


def device_ms_by_range(trace) -> dict:
    """{program range name: [complete ranges, device ms under them]}."""
    out: Dict[str, list] = {}
    for e in sorted(trace.ranges_, key=lambda e: float(e["ts"])):
        name = e.get("name", "")
        a = float(e["ts"])
        b = a + float(e["dur"])
        if name.startswith(PROGRAM_PREFIX) and trace.complete(a, b):
            row = out.setdefault(name, [0, 0.0])
            row[0] += 1
            row[1] += _device_ms(trace, a, b)
    return out


def chunkless_share(chunks: List[int], n: int) -> Optional[float]:
    """Of every run of ``n`` consecutive ticks in ``chunks`` (the prefill
    chunks each tick ran), the share in which no chunk ran: how often a
    traced slice of ``n`` ticks would leave ``prefill_chunk_device_ms``
    nothing to read."""
    runs = len(chunks) - n + 1
    if runs < 1:
        return None
    return sum(not any(chunks[i:i + n]) for i in range(runs)) / runs


def train_coverage(trace) -> Optional[float]:
    """The share of the complete traced steps' busy device time that lies
    under the three train ranges (a union of intervals, in %)."""
    steps = [(lo, hi) for lo, hi in trace.ranges("bench.train_step")
             if trace.complete(lo, hi)]
    inner = [(a, b) for name in TRAIN_RANGES for a, b in trace.ranges(name)
             if any(lo <= a and b <= hi for lo, hi in steps)]
    if not steps or not inner:
        return None
    busy = sum(trace.busy_us(trace.records_in(lo, hi)) for lo, hi in steps)
    covered = trace.busy_us([e for a, b in inner
                             for e in trace.records_in(a, b)])
    return 100.0 * covered / busy
