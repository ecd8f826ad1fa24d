"""The port's span tracer and flight recorder (repro_torch.serve.telemetry)
against the JAX package's.

* The span-tree scenarios of tests/test_telemetry.py (finish, cancel
  while queued and mid-prefill, cancel while decoding, the pool-dry pause
  and resume, eviction and copy-on-write instants, the flight dump on the
  no-progress error) run on both packages' engines over the same reduced
  model and requests; each engine must emit the same sequence of (phase,
  name, track) events, timestamps and args aside, and the port's own
  engine-track spans (``prefill_chunk``, ``emit``) left out.
* Each package's validator accepts the other's traces; the port's
  validator, exporter, CLI and ring behave as the reference's.
* ``telemetry=None`` constructs no tracer.
"""

import json

import jax
import numpy as np
import pytest

from repro.serve import engine as jengine
from repro.serve import telemetry as jtel
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.serve import engine as tengine
from repro_torch.serve import telemetry as ttel

PACKAGES = ("repro", "repro_torch")


@pytest.fixture(scope="module")
def models(serve_model):
    """{package: (api, params)} over the same reduced smollm-135m."""
    jcfg, japi, jparams = serve_model
    tcfg = get_config("smollm-135m").reduced(num_layers=2, d_model=32,
                                             d_ff=64, vocab_size=128)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return {"repro": (japi, jparams),
            "repro_torch": (get_model(tcfg), tparams)}


def _engine(models, pkg, **kw):
    api, params = models[pkg]
    mod = jengine if pkg == "repro" else tengine
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("telemetry", True)
    extra = {} if pkg == "repro" else {"device": "cpu"}
    return mod.Engine(api, params, mod.EngineConfig(**kw), **extra), mod


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 127, n).astype(np.int32) for n in lens]


#: the engine-track spans the port adds to the reference's, each with the
#: span it lies in: each prefill chunk's step, and the tick's token
#: emission
PORT_SPANS = {"prefill_chunk": "prefill_pass", "emit": "tick"}


def _sequence(events):
    """(phase, name, track) of each event, the port's own engine-track
    spans left out once each is checked to open inside its span and to
    close before anything else on the engine track closes."""
    out, open_ = [], []
    for _ts, ph, name, _cat, tid, _args in events:
        engine_span = tid == ttel.TID_ENGINE and ph in ("B", "E")
        if engine_span and ph == "B":
            assert name not in PORT_SPANS or PORT_SPANS[name] in open_, \
                (name, open_)
            open_.append(name)
        elif engine_span:
            assert name in open_, (name, open_)
            assert open_[-1] == name or name not in PORT_SPANS \
                and open_[-1] not in PORT_SPANS, (name, open_)
            del open_[len(open_) - 1 - open_[::-1].index(name)]
        if not (engine_span and name in PORT_SPANS):
            out.append((ph, name, tid))
    assert not set(open_) & set(PORT_SPANS), open_
    return out


def scenario_finish(models, pkg, tmp_path):
    eng, mod = _engine(models, pkg, tick_budget=12)
    for i, p in enumerate(_prompts(30, (3, 17, 40))):
        eng.submit(mod.Request(i, p, max_new_tokens=6))
    assert len(eng.run_to_completion()) == 3
    return eng


def scenario_cancel_queued_and_mid_prefill(models, pkg, tmp_path):
    eng, mod = _engine(models, pkg, max_batch=1, tick_budget=8,
                       prefix_cache=False)
    long_p, queued_p = _prompts(31, (40, 6))
    eng.submit(mod.Request(0, long_p, max_new_tokens=4))
    eng.submit(mod.Request(1, queued_p, max_new_tokens=4))
    eng.step()
    assert eng.admitting
    assert eng.cancel(1) and eng.cancel(0)
    return eng


def scenario_truncated_on_decode_cancel(models, pkg, tmp_path):
    eng, mod = _engine(models, pkg)
    [p] = _prompts(32, (6,))
    eng.submit(mod.Request(0, p, max_new_tokens=30))
    for _ in range(3):
        eng.step()
    assert eng.active and eng.cancel(0)
    return eng


def scenario_pool_dry_pause_resume(models, pkg, tmp_path):
    eng, mod = _engine(models, pkg, max_batch=2, num_pages=10,
                       prefix_cache=False, tick_budget=16)
    blocker_p, late_p = _prompts(33, (32, 40))
    eng.submit(mod.Request(0, blocker_p, max_new_tokens=12))
    eng.step()
    eng.submit(mod.Request(1, late_p, max_new_tokens=3))
    eng.run_to_completion()
    assert eng.stats()["paused_prefills"] > 0
    return eng


def scenario_eviction_and_cow(models, pkg, tmp_path):
    eng, mod = _engine(models, pkg, max_batch=2, num_pages=12,
                       prefix_cache=True)
    shared = _prompts(34, (16,))[0]
    for rid, tail_len in enumerate((8, 10, 12, 14)):
        tail = _prompts(35 + tail_len, (tail_len,))[0]
        eng.submit(mod.Request(rid, np.concatenate([shared, tail]),
                               max_new_tokens=4))
    eng.run_to_completion()
    assert eng.stats()["prefix_hit_tokens"] > 0
    return eng


def scenario_flight_dump_on_no_progress(models, pkg, tmp_path):
    mod = jengine if pkg == "repro" else tengine
    tel = jtel if pkg == "repro" else ttel
    flight = tmp_path / f"FLIGHT_{pkg}.json"
    eng, _ = _engine(models, pkg, max_batch=2, telemetry=tel.TelemetryConfig(
        trace=False, flight_path=str(flight)))
    assert eng.tel.events is None
    assert eng.alloc.claim(990) is not None
    assert eng.alloc.claim(991) is not None
    eng.submit(mod.Request(0, _prompts(36, (4,))[0]))
    with pytest.raises(RuntimeError, match="cannot make progress") as ei:
        eng.run_to_completion()
    assert f"[flight recorder: {flight}]" in str(ei.value)
    doc = json.loads(flight.read_text())
    assert doc["otherData"]["flight"] is True
    assert "cannot make progress" in doc["otherData"]["reason"]
    assert doc["traceEvents"]
    return eng


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_finish, scenario_cancel_queued_and_mid_prefill,
    scenario_truncated_on_decode_cancel, scenario_pool_dry_pause_resume,
    scenario_eviction_and_cow, scenario_flight_dump_on_no_progress)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_span_tree_scenarios_emit_the_same_events_on_both_packages(
        models, name, tmp_path):
    engines = {pkg: SCENARIOS[name](models, pkg, tmp_path)
               for pkg in PACKAGES}
    seqs = {}
    for pkg, eng in engines.items():
        tr = eng.tel
        seqs[pkg] = _sequence(tr.events if tr.events is not None
                              else tr.ring)
        assert seqs[pkg]
    assert seqs["repro_torch"] == seqs["repro"]
    port = engines["repro_torch"]
    if port.tel.events is None:
        return
    # both validators accept both traces
    for pkg, eng in engines.items():
        doc = (jtel if pkg == "repro" else ttel).to_chrome_trace(eng.tel)
        for tel in (jtel, ttel):
            v = tel.validate_chrome_trace(doc)
            assert v["ok"], (pkg, tel.__name__, v["errors"])
    names = {e[2] for e in port.tel.events if e[1] == "i"}
    s = port.stats()
    if name == "eviction_and_cow":
        assert ("eviction" in names) == (s["evictions"] > 0)
        assert ("cow_fork" in names) == (s["forked_pages"] > 0)
    if name == "pool_dry_pause_resume":
        assert {"paused", "resumed"} <= names


def test_port_trace_passes_the_reference_validator_and_cli(models,
                                                            tmp_path):
    eng, mod = _engine(models, "repro_torch", tick_budget=12)
    for i, p in enumerate(_prompts(40, (5, 20))):
        eng.submit(mod.Request(i, p, max_new_tokens=4))
    eng.run_to_completion()
    path = tmp_path / "trace.json"
    assert ttel.write_trace(eng.tel, path) == str(path)
    doc = json.loads(path.read_text())
    v = jtel.validate_chrome_trace(doc)
    assert v["ok"], v["errors"]
    s = v["summary"]
    assert s["requests"] == 2 and s["terminals"] == {"finish": 2}
    assert s["ticks"] > 1
    meta = doc["otherData"]["meta"]
    assert meta["engine"]["device"] == "cpu"
    assert meta["decode_plan"]["backend"]
    buckets = [e for e in eng.tel.events if e[2] == "decode_bucket"]
    assert buckets and all("native" in e[5] for e in buckets)
    assert ttel.main([str(path), "--quiet"]) == 0
    assert jtel.main([str(path), "--quiet"]) == 0


def test_port_validator_rejects_malformed_traces(tmp_path, capsys):
    def ev(ph, name, ts, tid=0):
        return {"name": name, "ph": ph, "ts": ts, "pid": 1, "tid": tid}

    misnested = {"traceEvents": [ev("B", "a", 0), ev("B", "b", 1),
                                 ev("E", "a", 2), ev("E", "b", 3)]}
    backwards = {"traceEvents": [ev("i", "x", 5.0), ev("i", "y", 1.0)]}
    no_terminal = {"traceEvents": [ev("B", "request", 0, 1001),
                                   ev("E", "request", 1, 1001)]}
    for doc in (misnested, backwards, no_terminal):
        assert not ttel.validate_chrome_trace(doc)["ok"]
        assert (ttel.validate_chrome_trace(doc)["errors"]
                == jtel.validate_chrome_trace(doc)["errors"])
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(misnested))
    assert ttel.main([str(path)]) == 1
    assert "INVALID" in capsys.readouterr().out


def test_port_flight_ring_and_tracer_specs():
    tr = ttel.Tracer(trace=False, ring=16)
    for i in range(100):
        tr.instant("e", n=i)
    assert len(tr.ring) == 16 and tr.dropped == 84 and tr.events is None
    assert ttel.make_tracer(None) is None
    assert ttel.make_tracer(False) is None
    assert ttel.make_tracer(True).events == []
    assert ttel.make_tracer("flight").events is None
    assert ttel.make_tracer(tr) is tr
    cfg = ttel.TelemetryConfig(trace=True, ring=0)
    assert ttel.make_tracer(cfg).ring is None
    with pytest.raises(ValueError, match="telemetry spec"):
        ttel.make_tracer("loud")


def test_disabled_telemetry_constructs_no_tracer(models, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a Tracer was constructed")

    monkeypatch.setattr(ttel.Tracer, "__init__", boom)
    eng, mod = _engine(models, "repro_torch", telemetry=None)
    assert eng.tel is None
    eng.submit(mod.Request(0, _prompts(41, (9,))[0], max_new_tokens=3))
    assert len(eng.run_to_completion()) == 1
