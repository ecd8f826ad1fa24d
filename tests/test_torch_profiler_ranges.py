"""The port's profiler ranges and latency stamps, on the CPU.

* A step of ``make_train_step`` under a ``torch.profiler`` session
  records ``repro_torch.train.forward``, ``.backward`` and ``.optimizer``
  in that order: once each, or a forward and a backward per microbatch.
* An engine with telemetry on mirrors its engine-track spans (``tick``,
  ``prefill_pass``, ``scheduler``, ``prefill_chunk``, ``decode_step``,
  ``emit``) as ``repro_torch.serve.*`` ranges that nest as the spans do,
  one ``prefill_chunk`` a chunk and one ``tick`` a tick; with telemetry
  off it records none.  The trace with the new spans validates (the emit
  path's transfer audit is tests/test_torch_serve_static.py's).
* ``Engine.stats()``' latencies are stamped at the readback that
  delivered the token: a slow tick shows inside ``ttft_ms`` and
  ``itl_ms``.
* ``Tracer.origin`` puts the trace's timestamps on ``perf_counter``'s
  clock.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve import telemetry as ttel
from repro_torch.serve.engine import Engine, EngineConfig, Request
from repro_torch.train import step as tstep

SMALL = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=128)
SERVE_SPANS = ("tick", "prefill_pass", "scheduler", "prefill_chunk",
               "decode_step", "emit")


@pytest.fixture(scope="module")
def model():
    cfg = get_config("smollm-135m").reduced(**SMALL)
    api = get_model(cfg)
    return api, api.init(torch.Generator().manual_seed(0), device="cpu")


def _ranges(prof, prefix):
    """(name, start µs, end µs) of the session's ranges whose name starts
    with ``prefix``, in order of start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(prefix)),
                  key=lambda x: (x[1], -x[2]))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_records_forward_backward_optimizer(model, microbatches):
    api, _ = model
    opt_cfg = AdamWConfig(lr=1e-3, grad_clip_norm=1.0)
    params, opt = tstep.init_train_state(
        api, opt_cfg, torch.Generator().manual_seed(1), device="cpu")
    step = tstep.make_train_step(api, opt_cfg, microbatches)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, SMALL["vocab_size"], (4, 16), generator=g)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, opt, batch)
    got = _ranges(prof, "repro_torch.train.")
    assert [n for n, _a, _b in got] == (
        [tstep.FORWARD_RANGE, tstep.BACKWARD_RANGE] * microbatches
        + [tstep.OPTIMIZER_RANGE])
    # one after the other, none inside another
    for (_n, _a, end), (_m, start, _b) in zip(got, got[1:]):
        assert end <= start


def _engine(model, telemetry):
    api, params = model
    return Engine(api, params, EngineConfig(
        max_batch=4, max_len=64, page_size=8, prefill_chunk=8,
        tick_budget=12, telemetry=telemetry), device="cpu")


def _serve(eng, lens=(5, 20, 13)):
    rng = np.random.default_rng(3)
    for i, n in enumerate(lens):
        eng.submit(Request(i, rng.integers(1, 127, n).astype(np.int32),
                           max_new_tokens=4))
    eng.run_to_completion()


def test_engine_mirrors_its_tick_phases_as_profiler_ranges(model):
    eng = _engine(model, True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(eng)
    got = _ranges(prof, ttel.RANGE_PREFIX)
    names = [n[len(ttel.RANGE_PREFIX):] for n, _a, _b in got]
    assert set(names) == set(SERVE_SPANS)
    assert names.count("prefill_chunk") == eng.counters["prefill_chunks"]
    assert names.count("decode_step") == eng.counters["decode_ticks"]
    assert names.count("tick") == sum(
        1 for e in eng.tel.events if e[1] == "B" and e[2] == "tick")
    # properly nested: two ranges are disjoint or one holds the other
    for i, (_n, a0, a1) in enumerate(got):
        for _m, b0, b1 in got[i + 1:]:
            assert b0 >= a1 or b1 <= a1
    # each phase inside the span the tracer opened it in
    parent = {"prefill_pass": ("tick",), "decode_step": ("tick",),
              "emit": ("tick",), "scheduler": ("prefill_pass",),
              "prefill_chunk": ("prefill_pass", "scheduler")}
    for i, (name, a, b) in enumerate(got):
        short = name[len(ttel.RANGE_PREFIX):]
        if short == "tick":
            continue
        holders = [(d - c, h) for j, (h, c, d) in enumerate(got)
                   if j != i and c <= a and b <= d]
        assert holders, short
        innermost = min(holders)[1][len(ttel.RANGE_PREFIX):]
        assert innermost in parent[short], (short, innermost)
    # the trace with the new spans still validates
    v = ttel.validate_chrome_trace(ttel.to_chrome_trace(eng.tel))
    assert v["ok"], v["errors"]
    spans = {e[2] for e in eng.tel.events if e[4] == ttel.TID_ENGINE
             and e[1] == "B"}
    assert {"prefill_chunk", "emit"} <= spans


def test_engine_without_telemetry_records_no_serve_range(model):
    eng = _engine(model, None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(eng)
    assert eng.tel is None
    assert _ranges(prof, ttel.RANGE_PREFIX) == []


def test_request_spans_are_not_mirrored():
    tr = ttel.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.request_submit(7, 10, 4, 0)
        tr.begin("tick")
        tr.request_admitted(7, 0, 0, 2)
        tr.end("tick")
    assert [n for n, _a, _b in _ranges(prof, "repro_torch.")] == [
        ttel.RANGE_PREFIX + "tick"]
    assert tr._ranges == []


def test_tracer_origin_is_on_the_host_clock():
    tr = ttel.Tracer()
    before = time.perf_counter()
    ts = tr.now()
    after = time.perf_counter()
    assert before - 1e-6 <= tr.origin + ts * 1e-6 <= after + 1e-6


def test_latency_stamps_hold_the_tick_that_produced_the_token(model):
    """``_select`` runs on every step's logits before the readback: a
    sleep there stands for a slow tick, and must show in the stamps."""
    slow = 0.05
    eng = _engine(model, None)
    select = eng._select

    def slow_select(logits):
        time.sleep(slow)
        return select(logits)

    eng._select = slow_select
    t0 = time.perf_counter()
    eng.submit(Request(0, np.arange(1, 6, dtype=np.int32),
                       max_new_tokens=3))
    eng.step()               # the prefill's first token, then a decode
    wall_ms = (time.perf_counter() - t0) * 1e3
    s = eng.stats()
    assert s["latency_samples"]["ttft_ms"] == 1
    # the prefill's readback came after one slow select; the tick's
    # decode after a second
    assert slow * 1e3 <= s["ttft_ms_p50"] <= wall_ms
    assert s["latency_samples"]["itl_ms"] == 1
    assert s["itl_ms_p50"] >= slow * 1e3
