"""The readers of the program's own ranges and request spans, on synthetic
traces and tracer events: what each reads, that a range which lost a
record or lies outside a complete step is left out, and that a program
without the ranges reads None."""

from __future__ import annotations

import types

import bench_tiny  # noqa: F401
import pytest

from harness import cell as cells
from harness import spans
from harness.stats import Timeline
from harness.trace import Trace

FWD, BWD, OPT = spans.TRAIN_RANGES


def _trace(kernels, ranges, lost=(), lo=0.0, hi=1000.0):
    """Kernels (start, end), each launched 1 µs before it starts; ranges
    (name, start, end); ``lost``: times of launches whose record is
    missing."""
    ev = [{"cat": "kernel", "name": "k", "ts": a, "dur": b - a,
           "args": {"correlation": i}} for i, (a, b) in enumerate(kernels)]
    ev += [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": a - 1,
            "dur": 1, "args": {"correlation": i}}
           for i, (a, _b) in enumerate(kernels)]
    ev += [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t,
            "dur": 1, "args": {"correlation": 10_000 + i}}
           for i, t in enumerate(lost)]
    ev += [{"cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
           for n, a, b in ranges]
    return Trace(ev, lo, hi)


def _r(trace):
    return types.SimpleNamespace(trace=trace)


TRAIN = dict(
    kernels=[(12, 20), (22, 30),        # step 1: forward
             (32, 60),                  # backward
             (62, 66),                  # optimizer
             (112, 118), (132, 160), (162, 168)],   # step 2
    ranges=[("bench.train_step", 10, 70), (FWD, 10, 30.5),
            (BWD, 30.5, 60.5), (OPT, 60.5, 70),
            ("bench.train_step", 110, 170), (FWD, 110, 130.5),
            (BWD, 130.5, 160.5), (OPT, 160.5, 170)])


def test_train_ranges_read_device_ms_per_step():
    r = _r(_trace(**TRAIN))
    # (8 + 8 + 6) µs of forward over 2 steps, (4 + 6) of optimizer
    assert spans.forward_device_ms(r) == pytest.approx(22e-3 / 2)
    assert spans.optimizer_device_ms(r) == pytest.approx(10e-3 / 2)
    assert spans.train_range_ms(r, BWD) == pytest.approx(56e-3 / 2)
    assert spans.train_coverage(r.trace) == pytest.approx(100.0)


def test_a_step_that_lost_a_record_is_left_out():
    r = _r(_trace(**TRAIN, lost=(150,)))
    assert spans.forward_device_ms(r) == pytest.approx(16e-3)
    assert spans.optimizer_device_ms(r) == pytest.approx(4e-3)


def test_coverage_counts_busy_time_outside_the_train_ranges():
    kernels = TRAIN["kernels"][:4] + [(67, 69)]    # a copy after the update
    ranges = TRAIN["ranges"][:3] + [(OPT, 60.5, 65.5)]
    cov = spans.train_coverage(_trace(kernels, ranges))
    assert cov == pytest.approx(100.0 * 48 / 50)


def test_a_program_without_the_ranges_reads_none():
    step_only = _trace(TRAIN["kernels"], [("bench.train_step", 10, 70),
                                          ("bench.train_step", 110, 170)])
    for read in (spans.forward_device_ms, spans.optimizer_device_ms,
                 spans.prefill_chunk_device_ms):
        assert read(_r(step_only)) is None
        assert read(_r(None)) is None
    assert spans.train_coverage(step_only) is None


def test_prefill_chunk_reads_each_complete_chunk():
    kernels = [(5, 45), (47, 49),        # chunk 1: a graph's kernels
               (55, 95),                 # chunk 2
               (105, 140)]               # chunk 3 lost a record
    ranges = [("bench.tick", 0, 100), ("repro_torch.serve.tick", 1, 99),
              (spans.PREFILL_CHUNK, 2, 50), (spans.PREFILL_CHUNK, 52, 96),
              ("bench.tick", 100, 200), (spans.PREFILL_CHUNK, 102, 150)]
    r = _r(_trace(kernels, ranges, lost=(110,)))
    assert spans.prefill_chunk_device_ms(r) == pytest.approx((42 + 40) / 2
                                                            * 1e-3)


def test_the_new_metrics_are_found_by_name():
    r = _r(_trace(**TRAIN))
    assert cells.reader("forward_device_ms.train")(r) == pytest.approx(
        11e-3)
    assert cells.reader("optimizer_device_ms.train")(r) == pytest.approx(
        5e-3)
    for name in ("prefill_chunk_device_ms.chat",
                 "prefill_chunk_device_ms.batch"):
        assert cells.reader(name)(r) is None


def test_device_ms_is_read_by_program_range():
    kernels = [(10, 20), (60, 70), (130, 140)]
    ranges = [("bench.tick", 0, 100), ("repro_torch.serve.tick", 5, 95),
              ("repro_torch.serve.emit", 70, 90),
              ("repro_torch.serve.tick", 105, 195)]    # lost a record
    got = spans.device_ms_by_range(_trace(kernels, ranges, lost=(150,)))
    assert got == {"repro_torch.serve.tick": [1, pytest.approx(20e-3)],
                   "repro_torch.serve.emit": [1, 0.0]}


def test_chunkless_share_counts_runs_without_a_chunk():
    # runs of 3 ticks: [0 0 2] [0 2 0] [2 0 0] [0 0 0] [0 0 1]
    assert spans.chunkless_share([0, 0, 2, 0, 0, 0, 1], 3) == \
        pytest.approx(1 / 5)
    assert spans.chunkless_share([1, 1], 2) == 0.0
    assert spans.chunkless_share([0, 0], 3) is None


# ---------------------------------------------------------------------------
# request spans
# ---------------------------------------------------------------------------

def _events():
    """Two requests whose spans interleave on their own tracks, and an
    engine-track span of another name; µs since an origin of 100 s."""
    t = spans.REQ_TID_BASE
    return [
        (0.0, "B", "request", "request", t + 1, None),
        (0.0, "B", "queued", "request", t + 1, None),
        (1e5, "B", "request", "request", t + 2, None),
        (1e5, "B", "queued", "request", t + 2, None),
        (2e5, "B", "tick", "tick", 0, None),
        (3e5, "E", "queued", "", t + 1, None),
        (3e5, "B", "prefill", "request", t + 1, None),
        (4e5, "E", "queued", "", t + 2, None),
        (4e5, "B", "prefill", "request", t + 2, None),
        (6e5, "E", "prefill", "", t + 1, None),
        (9e5, "E", "prefill", "", t + 2, None),
        (9.5e5, "E", "tick", "", 0, None),
    ]


def test_request_spans_pair_by_track_and_name():
    got = spans.request_spans(_events(), "queued", 100.0)
    assert got == {1: pytest.approx((100.0, 100.3)),
                   2: pytest.approx((100.1, 100.4))}
    assert spans.request_spans(_events(), "tick", 100.0) == {}


def test_mean_span_reads_the_spans_that_end_in_the_window():
    ev = _events()
    assert spans.mean_span_ms(ev, "queued", 100.0, 100.0, 101.0) == \
        pytest.approx(300.0)
    assert spans.mean_span_ms(ev, "queued", 100.0, 100.35, 101.0) == \
        pytest.approx(300.0)       # request 2 alone
    assert spans.mean_span_ms(ev, "prefill", 100.0, 100.0, 100.7) == \
        pytest.approx(300.0)       # request 1 alone
    assert spans.mean_span_ms(ev, "prefill", 100.0, 101.0, 102.0) is None
    assert spans.mean_span_ms([], "queued", 100.0, 100.0, 101.0) is None


def test_ttft_splits_into_lag_queued_prefill_and_rest():
    tl = Timeline()
    tl.add(1, 99.95)                  # submitted 50 ms after its due time
    tl.add(2, 100.1)
    tl.add(3, 100.2)                  # never served: in the p90 only
    tl.token(1, 100.61)
    tl.token(2, 100.9)
    s = spans.ttft_split(tl, _events(), 100.0, 99.0, 101.0)
    m = s["mean"]
    assert m["n"] == 2
    assert m["submit_lag"] == pytest.approx(25.0)
    assert m["queued"] == pytest.approx(300.0)
    assert m["prefill"] == pytest.approx(400.0)
    assert m["rest"] == pytest.approx(5.0)
    assert m["ttft"] == pytest.approx((660 + 800) / 2)
    assert m["ttft"] == pytest.approx(
        m["submit_lag"] + m["queued"] + m["prefill"] + m["rest"])
    # the p90 of 660, 800 and the unserved 800 is 800: request 2 alone
    assert s["ttft_p90_ms"] == pytest.approx(800.0)
    assert s["at_or_beyond_p90"]["n"] == 1
    assert s["ttft_queued_ms"] == pytest.approx(300.0)
    assert s["ttft_mean_ms"] == pytest.approx((660 + 800 + 800) / 3)
    assert spans.ttft_split(tl, [], 100.0, 99.0, 101.0) is None


def test_ttft_pass_splits_a_window_of_chat_traffic():
    import time

    import bench_tiny
    import split
    import torch

    from repro_torch.models.registry import get_model

    c, cfg = bench_tiny.tiny_cell("smollm-inh.chat")
    t0 = time.perf_counter()
    s = split.ttft_pass(c, get_model(cfg), 21, 1.0, torch.device("cpu"),
                        lambda: None)
    assert time.perf_counter() - t0 < 60
    m = s["mean"]
    assert m["n"] >= 3
    for part in ("submit_lag", "queued", "prefill", "rest"):
        assert m[part] >= 0.0, (part, m)
    assert m["ttft"] == pytest.approx(
        m["submit_lag"] + m["queued"] + m["prefill"] + m["rest"])
    assert s["ttft_queued_ms"] is not None
    assert s["ttft_prefill_ms"] is not None
