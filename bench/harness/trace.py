"""Reading a ``torch.profiler`` trace of part of the measured window.

A traced slice runs inside one profiler session, after ``PAD`` tiny fills:
on the H100 a session drops its first device records, more the longer the
process has run, so the fills take that loss.  The trace is exported as
Chrome trace JSON (into the run's TMPDIR) and read back: the device
records (kernels, copies, fills), the runtime calls that made them (a
CUDA-graph replay's kernels carry its launch's correlation id) and the
ranges the benchmark and the program record.  Device time is attributed
to a range by the runtime calls made inside it, and a range any of whose
calls lost its record is left out (``complete``).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_RECORDS = ("kernel", "gpu_memcpy", "gpu_memset")
WORK_CALLS = ("Launch", "Memcpy", "Memset")
PAD = 1000
# idle gaps named by the host operation under way, longest first
GAPS_NAMED = 200
# a kernel's name, cut to this many characters in the breakdown
NAME_CHARS = 160


class Trace:
    """The parsed records of one traced slice; times in µs."""

    def __init__(self, events: List[dict], lo: float, hi: float):
        self.lo, self.hi = lo, hi
        self.device = [e for e in events if e.get("cat") in DEVICE_RECORDS]
        self.calls = [e for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and "correlation" in e.get("args", {})
                      and any(w in e.get("name", "") for w in WORK_CALLS)]
        self.ranges_ = [e for e in events
                        if e.get("cat") == "user_annotation"]
        self.cpu_ops = [e for e in events if e.get("cat") == "cpu_op"]
        self._by_corr: Dict[int, List[dict]] = {}
        for e in self.device:
            c = e.get("args", {}).get("correlation")
            self._by_corr.setdefault(c, []).append(e)

    def ranges(self, name: str) -> List[Tuple[float, float]]:
        return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in self.ranges_ if e.get("name") == name)

    def calls_in(self, lo: float, hi: float) -> List[dict]:
        return [c for c in self.calls if lo <= float(c["ts"]) <= hi]

    def records_of(self, calls: List[dict]) -> List[dict]:
        return [r for c in calls
                for r in self._by_corr.get(c["args"]["correlation"], ())]

    def complete(self, lo: float, hi: float) -> bool:
        """Did every runtime call inside [lo, hi] leave its record?"""
        return all(c["args"]["correlation"] in self._by_corr
                   for c in self.calls_in(lo, hi))

    def records_in(self, lo: float, hi: float) -> List[dict]:
        return self.records_of(self.calls_in(lo, hi))

    def window_records(self) -> List[dict]:
        return [e for e in self.device
                if float(e["ts"]) + float(e["dur"]) > self.lo
                and float(e["ts"]) < self.hi]

    def busy_us(self, records: Optional[List[dict]] = None,
                lo: Optional[float] = None,
                hi: Optional[float] = None) -> float:
        """Union of the records' intervals, clipped to [lo, hi] (default:
        the traced window)."""
        lo = self.lo if lo is None else lo
        hi = self.hi if hi is None else hi
        recs = self.window_records() if records is None else records
        busy, end = 0.0, lo
        for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in recs):
            a, b = max(a, end), min(b, hi)
            if b > a:
                busy += b - a
                end = b
        return busy

    def named_us(self, records: List[dict],
                 *needles: str) -> Tuple[float, int]:
        """(summed µs, count) of the kernels whose name holds a needle."""
        hit = [r for r in records if r.get("cat") == "kernel"
               and any(n in r.get("name", "") for n in needles)]
        return sum(float(r["dur"]) for r in hit), len(hit)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the window by the host operation under way at each gap's
        middle (the innermost range or operator holding it), in seconds."""
        ops: Dict[str, float] = {}
        recs = self.window_records()
        for r in recs:
            name = r.get("name", "?")[:NAME_CHARS]
            ops[name] = ops.get(name, 0.0) + float(r["dur"]) * 1e-6
        found = []
        end = self.lo
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in recs) + [(self.hi, self.hi)]
        for a, b in spans:
            if a > end:
                found.append((a - end, 0.5 * (a + end)))
            end = max(end, b)
        # the longest gaps, each named by the innermost host range or
        # operator holding its middle
        host = self.ranges_ + self.cpu_ops
        gaps: Dict[str, float] = {}
        for length, mid in sorted(found, reverse=True)[:GAPS_NAMED]:
            holding = [e for e in host if float(e["ts"]) <= mid
                       <= float(e["ts"]) + float(e["dur"])]
            name = (min(holding, key=lambda e: float(e["dur"]))["name"]
                    [:NAME_CHARS] if holding
                    else "host: no recorded operation")
            gaps[name] = gaps.get(name, 0.0) + length * 1e-6
        def order(d):
            return sorted(d.items(), key=lambda kv: -kv[1])[:top]

        return {"device_ops": [[k, v] for k, v in order(ops)],
                "idle_gaps": [[k, v] for k, v in order(gaps)]}


@contextlib.contextmanager
def traced(label: str, out: dict):
    """Profile the block (after ``PAD`` tiny fills) inside a range named
    ``label``; on exit ``out["trace"]`` holds the :class:`Trace` of the
    range.  The block synchronizes the device before it ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    fill = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD):
            fill.zero_()
        torch.cuda.synchronize()
        with record_function(label):
            yield
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    span = [e for e in events if e.get("name") == label
            and e.get("cat") == "user_annotation"]
    if len(span) != 1:
        raise RuntimeError(f"{len(span)} {label!r} ranges in the trace")
    lo = float(span[0]["ts"])
    out["trace"] = Trace(events, lo, lo + float(span[0]["dur"]))
