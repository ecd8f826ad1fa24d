"""Rates, tails and idle shares are taken over whole windows: a stall
counts, and a request that is late or never served lands in the tail."""

from __future__ import annotations

import types

import bench_tiny  # noqa: F401
import pytest

from harness import readers
from harness.stats import Timeline, percentile
from harness.trace import Trace


def test_percentile_interpolates_between_ranks():
    assert percentile([1, 2, 3, 4, 5], 50) == 3
    assert percentile([1, 2, 3, 4], 90) == pytest.approx(3.7)
    assert percentile([7.0], 95) == 7.0


def test_unserved_request_counts_its_wait():
    tl = Timeline()
    tl.add(1, 1.0)
    tl.token(1, 1.2)
    tl.add(2, 2.0)                       # never served before the close
    tl.add(3, 0.5)                       # due before the window
    tl.token(3, 1.1)
    ttft = sorted(tl.ttft_ms(1.0, 10.0))
    assert ttft == pytest.approx([200.0, 8000.0])


def test_stall_shows_in_the_gaps():
    tl = Timeline()
    tl.add(1, 0.0)
    for t in (0.1, 0.2, 0.3, 5.3):
        tl.token(1, t)
    tl.finish(1, 5.3)
    gaps = tl.itl_ms(0.0, 10.0)
    assert max(gaps) == pytest.approx(5000.0)
    tl.add(2, 0.0)
    tl.token(2, 1.0)                     # then nothing until the close
    assert max(tl.itl_ms(0.0, 10.0)) == pytest.approx(9000.0)


def test_tokens_in_window_only():
    tl = Timeline()
    tl.add(1, 0.0)
    for t in (0.5, 1.5, 2.5):
        tl.token(1, t)
    assert tl.tokens_in(1.0, 3.0) == 2


def _fake_trace(records, lo, hi, ranges=()):
    ev = [{"cat": "kernel", "name": n, "ts": a, "dur": b - a,
           "args": {"correlation": i}} for i, (n, a, b) in enumerate(records)]
    ev += [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": a - 1,
            "dur": 1, "args": {"correlation": i}}
           for i, (_n, a, _b) in enumerate(records)]
    ev += [{"cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
           for n, a, b in ranges]
    return Trace(ev, lo, hi)


def test_idle_share_is_over_the_whole_window():
    tr = _fake_trace([("k", 10, 30), ("k", 20, 40), ("k", 80, 90)], 0, 100)
    r = types.SimpleNamespace(trace=tr)
    assert readers.idle_pct(r) == pytest.approx(60.0)
    assert tr.busy_us() == pytest.approx(40.0)
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "k"
    assert sum(s for _n, s in b["idle_gaps"]) == pytest.approx(60e-6)


def test_idle_share_over_ranges():
    tr = _fake_trace([("k", 10, 30)], 0, 100, [("bench.train_step", 0, 40)])
    r = types.SimpleNamespace(trace=tr)
    assert readers.idle_pct(r, "bench.train_step") == pytest.approx(50.0)


def test_no_trace_reads_nothing():
    r = types.SimpleNamespace(trace=None, tail_ticks=[], model={})
    assert readers.idle_pct(r) is None
    assert readers.decode_device_ms(r) is None
    assert readers.paged_roofline_pct(r) is None
