"""A run with its timed path broken underneath comes out not correct, and
so does the control (the reference in float8 in the program's place); a
sound run comes out correct.  These drive the whole harness at a small
size on the CPU, past its look for a card."""

from __future__ import annotations

import time

import bench_tiny
import pytest
import torch

from harness import checks, runner, serve, train

CPU = torch.device("cpu")


def _run(name, fault=None, seconds=1.0, seed=21, size="tiny", **mix):
    c, cfg = bench_tiny.tiny_cell(name, size, **mix)
    res, out = runner.run_cell(c, seed, seconds, False, CPU,
                               time.perf_counter(), cfg=cfg, fault=fault)
    return c, res, out


def test_sound_training_run_is_correct():
    _c, res, out = _run("smollm-inh.train")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_faults_are_caught(fault):
    _c, res, _out = _run("smollm-inh.train", fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["smollm-inh.chat", "llava7b-inh.batch"])
def test_sound_serving_run_is_correct(name):
    c, res, out = _run(name)
    assert res["correct"], res["checks"]
    assert out["notes"]["checked_tokens"] > 0
    assert {m["name"] for m in c.end_to_end} == set(res["metrics"])


@pytest.mark.parametrize("name", ["smollm-inh.chat", "llava7b-inh.batch"])
def test_altered_token_is_caught(name):
    _c, res, _out = _run(name, fault="token")
    assert not res["correct"], res["checks"]


def test_training_control_fails_a_limit():
    c, cfg = bench_tiny.tiny_cell("smollm-inh.train", "control")
    ref = train.reference_train(c, 4, CPU)
    low = train.reference_train(c, 4, CPU, prec="fp8")
    ok, shown = checks.verdict(checks.train_readings(low, ref),
                               checks.limits_of(c.model, "train"))
    assert not ok, shown


@pytest.mark.parametrize("name", ["smollm-inh.chat", "llava7b-inh.batch"])
def test_serving_control_fails_the_limit(name):
    # the program's served tokens for the mix's first requests at the
    # control size, drained to completion (some hundreds of tokens), then
    # the float8 reference in its place at every position
    import itertools

    from harness import traffic, weights
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import Engine, Request

    c, cfg = bench_tiny.tiny_cell(name, "control", output_len=[24, 64])
    params = weights.draw(c.model, 21, CPU)
    eng = Engine(get_model(cfg), params,
                 serve.engine_config(c.model["serve"], False), device=CPU)
    reqs = [Request(p.index, p.prompt, max_new_tokens=p.max_new)
            for p in itertools.islice(
                traffic.requests(c.mix, c.model["vocab_size"], 21), 8)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    gap = 0.0
    for r in reqs:
        ref = serve.reference_logits(params, c.model, r.prompt, r.output, CPU)
        low = serve.reference_logits(params, c.model, r.prompt, r.output,
                                     CPU, prec="fp8")
        assert checks.served_gap(ref, torch.tensor(r.output)) < 1e-3
        gap = max(gap, checks.served_gap(ref, low.argmax(-1)))
    assert sum(len(r.output) for r in reqs) >= 200
    assert gap >= checks.limits_of(c.model, "serve")["logit_gap"], gap
