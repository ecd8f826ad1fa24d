"""Serve-path metrics: counters plus bounded reservoir histograms.

Port of the metrics half of :mod:`repro.serve.telemetry`
(``MetricsRegistry`` and its ``Histogram``), which ``Engine.stats()``
reads.  The span tracer and flight recorder are later work; the port's
engine keeps ``Engine.tel = None``.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List

import numpy as np


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
        v = float(v)
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
        return float(np.percentile(self._vals, p))

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

    def counter(self, name: str, inc: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + inc

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

