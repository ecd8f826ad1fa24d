"""End-to-end statistics over a whole measured window.

Each is taken over all the work and all the time of the window: a rate
over the window's seconds, a tail over every request or gap, never a
median of pieces.  A request due in the window that has no first token
when the window closes counts with its wait so far; a request still
decoding at the close counts its open gap, so a stall shows.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The p-th percentile, interpolated between the closest ranks (the
    "linear" method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    k = (len(xs) - 1) * p / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


class Timeline:
    """Host times of each request's due moment and of each of its tokens
    (as ``Request.on_token`` saw them), in seconds."""

    def __init__(self):
        self.due: Dict[int, float] = {}
        self.tokens: Dict[int, List[float]] = {}
        self.finished: Dict[int, float] = {}

    def add(self, rid: int, due: float) -> None:
        self.due[rid] = due
        self.tokens[rid] = []

    def token(self, rid: int, t: float) -> None:
        self.tokens[rid].append(t)

    def finish(self, rid: int, t: float) -> None:
        self.finished[rid] = t

    def ttft_ms(self, lo: float, hi: float) -> List[float]:
        """Time to first token of every request due in [lo, hi), from its
        due moment; one with no token by ``hi`` counts ``hi - due``."""
        out = []
        for rid, due in self.due.items():
            if lo <= due < hi:
                toks = self.tokens[rid]
                first = toks[0] if toks and toks[0] <= hi else hi
                out.append((first - due) * 1e3)
        return out

    def itl_ms(self, lo: float, hi: float) -> List[float]:
        """Every gap between consecutive tokens of a request whose later
        token falls in (lo, hi]; a request unfinished at ``hi`` adds its
        open gap since its last token."""
        out = []
        for rid, toks in self.tokens.items():
            prev = None
            for t in toks:
                if t > hi:
                    break
                if prev is not None and t > lo:
                    out.append((t - prev) * 1e3)
                prev = t
            done = self.finished.get(rid)
            if prev is not None and (done is None or done > hi):
                out.append((hi - prev) * 1e3)
        return out

    def tokens_in(self, lo: float, hi: float) -> int:
        return sum(lo < t <= hi for toks in self.tokens.values()
                   for t in toks)
