"""The port's serve analyzer (repro_torch.analysis.serve_static) and the
engine's compile accounting, against the JAX package.

* Pass 1: the retrace-budget proof (the prefill and decode bucket
  enumerations, the chunk-resume closure, the declared budget) returns
  the reference's dict, key for key, over a grid of configs.
* Pass 2: the host-sync audit over torch's transfer surfaces finds 2 h2d
  + 1 d2h a steady decode tick in the port's engine, rejects an untagged
  site, and finds no transfer on the telemetry emit path.
* The engine: its ``retrace_budget()`` and ``engine_desc`` equal the
  reference engine's; a compile count forced over the budget raises at
  drain.
* Pass 3 and the report: ``analyze_serve`` end to end on the reduced
  smollm-135m (ok, every signature built on meta tensors, one roofline
  entry per proven bucket, no host sync inside a step, JSON-
  serialisable); the reduced rwkv6-7b rejected (prefill proven >
  declared); the CLI's exit codes 0 / 1 and schema 2;
  ``cross_check_bench`` equal to the reference's on the same dict
  literals; an untraceable signature reported, not raised.
* The kernel registry's timed ``choose`` with an injected timer, in the
  cost model's prior order.
"""

import ast
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.analysis import serve_static as jstatic
from repro.serve import engine as jengine
from repro_torch.analysis import serve_static as tstatic
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops as kops
from repro_torch.models.registry import get_model
from repro_torch.serve import engine as tengine

GRID = list(itertools.product((16, 64, 200), (4, 8, 32), (None, 8, 16),
                              (True, False), (True, False)))


@pytest.mark.parametrize("max_len,chunk,page,prefix,bucketed", GRID)
def test_retrace_budget_equals_the_reference(max_len, chunk, page, prefix,
                                             bucketed):
    kw = dict(bucketed=bucketed, paged=page is not None, max_len=max_len,
              prefill_chunk=chunk, page_size=page,
              pages_per_slot=-(-max_len // page) if page else None,
              prefix_cache=prefix)
    got = tstatic.retrace_budget(**kw)
    assert got == jstatic.retrace_budget(**kw)
    enum = dict(max_len=max_len, prefill_chunk=chunk, bucketed=bucketed,
                page_size=page, prefix_cache=prefix)
    assert (tstatic.enumerate_prefill_buckets(**enum)
            == jstatic.enumerate_prefill_buckets(**enum)
            == got["prefill"]["buckets"])
    assert (tstatic.verify_chunk_resume(**enum)
            == jstatic.verify_chunk_resume(**enum))
    if page is not None:
        dec = dict(max_len=max_len, page_size=page,
                   pages_per_slot=-(-max_len // page))
        assert (tstatic.enumerate_decode_buckets(**dec)
                == jstatic.enumerate_decode_buckets(**dec)
                == got["decode"]["buckets"])


# ---------------------------------------------------------------------------
# pass 2: host-sync audit
# ---------------------------------------------------------------------------

CALLS = [
    ("x.to(self.device)", (".to(device)", "h2d")),
    ("x.to(device=dev)", (".to(device)", "h2d")),
    ("x.to('cuda:0')", (".to(device)", "h2d")),
    ("x.to(torch.device('cuda'))", (".to(device)", "h2d")),
    ("x.to('cpu')", (".to(cpu)", "d2h")),
    ("x.to(torch.int32)", None),
    ("buf.copy_(torch.from_numpy(a))", ("copy_(from_numpy)", "h2d")),
    ("buf.copy_(other)", None),
    ("torch.from_numpy(a)", None),
    ("torch.as_tensor(a, device=dev)", ("torch.as_tensor(device=)", "h2d")),
    ("torch.tensor([1], device='cuda')", ("torch.tensor(device=)", "h2d")),
    ("torch.as_tensor(a)", None),
    ("x.cpu()", (".cpu", "d2h")),
    ("x.item()", (".item", "d2h")),
    ("x.tolist()", (".tolist", "d2h")),
    ("x.numpy()", (".numpy", "d2h")),
    ("int(x)", ("int()", "d2h")),
    ("float(x[0])", ("float()", "d2h")),
    ("int(3)", None),
    ("torch.cuda.synchronize()", ("torch.cuda.synchronize", "d2h")),
    ("np.asarray(x)", None),
]


@pytest.mark.parametrize("src,want", CALLS, ids=[c[0] for c in CALLS])
def test_classify_sync_call_over_torch_surfaces(src, want):
    assert tstatic.classify_sync_call(ast.parse(src).body[0].value) == want


def test_engine_audit_counts_two_h2d_and_one_d2h_a_tick():
    s = tstatic.audit_engine_file()
    assert s["ok"], s["unallowlisted"]
    assert s["per_tick"] == {"h2d": 2, "d2h": 1}
    assert s["block_table_uploads_per_tick"] == 1
    tick = {(x["func"], x["api"], x["kind"]) for x in s["sites"]
            if x["freq"] == "tick" and x["cls"] != "host"}
    assert tick == {("step", "copy_(from_numpy)", "h2d"),
                    ("_flush_tables", "copy_(from_numpy)", "h2d"),
                    ("step", ".tolist", "d2h")}
    assert all(x["cls"] == "required" for x in s["sites"]
               if x["freq"] in ("tick", "admission"))
    funcs = tstatic.tick_path_functions(
        ast.parse(open(tengine.__file__).read()))
    assert {"_flush_tables", "_exec_chunks", "_decode_step_for",
            "_prefill_step_for", "_copy_page", "_finish"} <= funcs


ENGINE_SRC = '''
class Engine:
    def step(self):
        self._flush()
        x = self.buf.tolist()  # sync: required — next tokens
        {extra}

    def _flush(self):
        self.t.copy_(torch.from_numpy(self.host))  # sync: required — tables
'''


def test_audit_rejects_an_untagged_site_and_a_broken_contract():
    ok = tstatic.sync_summary(tstatic.audit_sync_sites(
        ENGINE_SRC.format(extra="pass")))
    assert ok["ok"] and ok["per_tick"] == {"h2d": 1, "d2h": 1}
    untagged = tstatic.sync_summary(tstatic.audit_sync_sites(
        ENGINE_SRC.format(extra="y = self.loss.item()")))
    assert not untagged["ok"]
    assert [x["api"] for x in untagged["unallowlisted"]] == [".item"]
    over = tstatic.sync_summary(tstatic.audit_sync_sites(ENGINE_SRC.format(
        extra="y = self.loss.item()  # sync: required — a second read")))
    assert not over["ok"] and over["per_tick"]["d2h"] == 2
    host = tstatic.sync_summary(tstatic.audit_sync_sites(ENGINE_SRC.format(
        extra="y = int(n)  # sync: host — n is a python int")))
    assert host["ok"] and host["per_tick"]["d2h"] == 1


def test_telemetry_emit_path_makes_no_transfer():
    s = tstatic.audit_telemetry_file()
    assert s["ok"], s["unallowlisted"]
    assert s["per_tick"] == {"h2d": 0, "d2h": 0}
    assert s["declared_per_tick"] == {"h2d": 0, "d2h": 0}
    assert all(x["cls"] == "host" for x in s["sites"])


# ---------------------------------------------------------------------------
# the engine's budget and its drain check
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(serve_model):
    jcfg, japi, jparams = serve_model
    tcfg = get_config("smollm-135m").reduced(num_layers=2, d_model=32,
                                             d_ff=64, vocab_size=128)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")

    def make(pkg, **kw):
        if pkg == "repro":
            return jengine.Engine(japi, jparams, jengine.EngineConfig(**kw))
        return tengine.Engine(get_model(tcfg), tparams,
                              tengine.EngineConfig(**kw), device="cpu")
    return make


@pytest.mark.parametrize("allocator", ["paged", "contiguous"])
@pytest.mark.parametrize("prefix_cache", [True, False])
def test_engine_retrace_budget_equals_the_reference_engines(
        engines, allocator, prefix_cache):
    kw = dict(max_batch=2, max_len=64, page_size=8, prefill_chunk=8,
              allocator=allocator, prefix_cache=prefix_cache)
    port = engines("repro_torch", **kw)
    assert port.retrace_budget() == engines("repro", **kw).retrace_budget()
    assert port.stats()["retrace_budget"] == port.retrace_budget()


def test_compile_count_over_the_budget_raises_at_drain(engines):
    eng = engines("repro_torch", max_batch=2, max_len=64, page_size=8,
                  prefill_chunk=8)
    eng.submit(tengine.Request(0, np.arange(1, 12, dtype=np.int32),
                               max_new_tokens=3))
    eng.run_to_completion()
    b = eng.retrace_budget()
    assert eng.decode_compiles <= b["decode_proven"]
    assert eng.prefill_compiles <= b["prefill_proven"]
    for w in range(b["decode_proven"] + 1):     # one more than proven
        eng._decode_step_for(1000 + w)
    with pytest.raises(RuntimeError, match="SOUNDNESS BUG"):
        eng._check_compile_soundness()
    with pytest.raises(RuntimeError, match="SOUNDNESS BUG"):
        eng.run_to_completion()


def test_unknown_warmup_policy_is_refused(engines):
    with pytest.raises(ValueError, match="warmup policy"):
        engines("repro_torch", max_len=64, warmup="eager")


# ---------------------------------------------------------------------------
# the kernel registry's timed choice
# ---------------------------------------------------------------------------

def test_registry_times_candidates_with_an_injected_timer():
    r = kops.KernelRegistry()
    key = ("inhibitor", 32, 16, 9, 3, 64)
    seconds = {4: 3e-6, 1: 2e-6, 2: None, 8: 1e-6}
    timed = []

    def timer(c):
        timed.append(c.pages_per_step)
        if seconds[c.pages_per_step] is None:
            raise ValueError("refused by the wrapper")
        return seconds[c.pages_per_step]

    got = r.choose("paged", key, "cuda", timer=timer)
    # the cost model's prior order (fewest splits first: the fewest
    # partials to write and merge), the refused candidate dropped, the
    # fastest kept
    assert timed == [8, 4, 2, 1] and got.pages_per_step == 8
    assert [c.pages_per_step for c, _ in r.priors[("paged",) + key]] == \
        [8, 4, 2, 1]
    d = r.decisions[("paged",) + key]
    assert d["source"] == "timed" and d["native"] is True
    # cached per shape: no second timing
    assert r.choose("paged", key, "cuda", timer=timer) == got
    assert timed == [8, 4, 2, 1]
    # an override merges onto the tuned choice
    over = r.choose("paged", key, "cuda",
                    kops.KernelChoice(block_q=64), timer=timer)
    assert over.pages_per_step == 8 and over.block_q == 64
    # ties keep the earlier-timed candidate (the cheapest prior); a
    # launch error raises
    r2 = kops.KernelRegistry()
    assert r2.choose("paged", key, "cuda",
                     timer=lambda c: 1.0).pages_per_step == 8

    def broken(c):
        raise RuntimeError("paged_inhibitor_decode launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        r2.choose("paged", ("flash",) + key[1:], "cuda", timer=broken)


def test_registry_without_a_timer_keeps_the_default_uncached():
    r = kops.KernelRegistry()
    key = ("flash", 8, 16, 9, 3, 64)
    assert r.choose("paged", key, "cuda") == kops.CANDIDATES["paged"][0]
    assert r.decisions[("paged",) + key]["source"] == "default-trace"
    assert ("paged",) + key not in r.tuned
    got = r.choose("paged", key, "cuda", timer=lambda c: c.pages_per_step)
    assert got.pages_per_step == 1
    assert r.decisions[("paged",) + key]["source"] == "timed"


def test_paged_wrappers_on_the_cpu_take_the_default_and_count_plain_calls():
    kops.registry.reset()
    kops.reset_counts()
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 1, 4, 16), generator=g)
    pool = torch.randn((5, 8, 2, 16), generator=g)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lengths = torch.tensor([5, 12], dtype=torch.int32)
    kops.paged_flash_inhibitor(q, pool, pool, tables, lengths)
    [d] = kops.registry.decisions.values()
    assert d["source"] == "default-cpu" and not kops.registry.tuned
    assert kops.counts()["paged_inhibitor_plain"] == 1
    with kops._uncounted():
        kops.paged_flash_inhibitor(q, pool, pool, tables, lengths)
    assert kops.counts()["paged_inhibitor_plain"] == 1
    kops.add_counts({"paged_inhibitor": 30})
    assert kops.counts()["paged_inhibitor"] == 30
    kops.reset_counts()


# ---------------------------------------------------------------------------
# pass 3 and the report: signatures, roofline, analyze_serve, the CLI
# ---------------------------------------------------------------------------

SMALL = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=128)
GEOM = dict(max_batch=2, max_len=32, page_size=8, prefill_chunk=8)


def test_analyze_serve_end_to_end(tmp_path):
    import json

    doc = tstatic.analyze_serve("smollm-135m", reduced=SMALL,
                                engine_kw=dict(GEOM))
    assert doc["ok"] and doc["schema"] == 2 == tstatic.SCHEMA_VERSION
    assert doc["family"] == "dense" and doc["engine_kw"] == GEOM
    for alloc in ("paged", "contiguous"):
        arm = doc["allocators"][alloc]
        assert arm["ok"] and arm["retrace"]["within_budget"]
        assert arm["signatures"]["verified"]
        assert arm["roofline"]["jit_host_callbacks"] == 0
        # one roofline entry per proven decode bucket and prefill width
        dec = arm["roofline"]["decode"]["per_bucket"]
        assert len(dec) == arm["retrace"]["decode"]["proven"]
        assert (sorted(map(int, arm["roofline"]["prefill"]["per_bucket"]))
                == arm["retrace"]["prefill"]["buckets"])
        assert len(arm["signatures"]["decode"]) == len(dec)
        # the walk took the plain path on meta; the engine plans its own
        assert arm["roofline"]["walked"]["device"] == "meta"
        t = arm["roofline"]["transfers_per_tick"]
        assert (t["h2d_ops"], t["d2h_ops"]) == (
            (2, 1) if alloc == "paged" else (1, 1))
    # wider decode buckets read more bytes
    pb = doc["allocators"]["paged"]["roofline"]["decode"]["per_bucket"]
    assert pb["1"]["hbm_bytes"] < pb["2"]["hbm_bytes"] < pb["4"]["hbm_bytes"]
    assert doc["sync_audit"]["ok"] and doc["sync_audit_telemetry"]["ok"]
    (tmp_path / "a.json").write_text(json.dumps(doc))  # JSON-serialisable
    text = tstatic.format_serve_report(doc)
    assert "=> OK" in text and "table uploads/tick=1" in text


def test_analyzer_rejects_the_unbucketed_family():
    """rwkv (ssm family) prefills exact-width chunks: its step set grows
    with the prompt lengths and must fail the budget proof."""
    doc = tstatic.analyze_serve("rwkv6-7b", reduced={},
                                engine_kw=dict(GEOM))
    assert not doc["ok"] and doc["family"] == "ssm"
    for arm in doc["allocators"].values():
        assert arm["engine"]["allocator"] == "contiguous"
        assert not arm["engine"]["bucketed"]
        r = arm["retrace"]
        assert not r["within_budget"]
        assert r["prefill"]["proven"] == 8 > r["prefill"]["declared"] == 4
        # every exact width is still a buildable, walkable signature
        assert arm["signatures"]["verified"]
        assert [s["width"] for s in arm["signatures"]["prefill"]] == \
            list(range(1, 9))
        roof = arm["roofline"]
        assert roof["walked"]["decode_backend"] == "naive"
        assert roof["transfers_per_tick"]["h2d_ops"] == 1
        assert roof["jit_host_callbacks"] == 0


def test_cli_exit_codes_and_schema(tmp_path):
    import json

    from repro_torch.analysis import serve as cli

    out = tmp_path / "ANALYSIS_serve.json"
    rc = cli.main(["--config", "smollm-135m", "--reduced",
                   "--max-batch", "2", "--max-len", "32",
                   "--page-size", "8", "--prefill-chunk", "8",
                   "--out", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["ok"] and doc["schema"] == 2
    rc = cli.main(["--config", "rwkv6-7b", "--reduced",
                   "--max-batch", "2", "--max-len", "32",
                   "--page-size", "8", "--prefill-chunk", "8",
                   "--out", str(tmp_path / "rejected.json")])
    assert rc == 1
    assert not json.loads((tmp_path / "rejected.json").read_text())["ok"]
    # a bench artifact whose measured count is over the proof fails it
    bench = tmp_path / "bench.json"
    bench.write_text(json.dumps({"paged": {
        "engine": doc["allocators"]["paged"]["engine"],
        "prefill_compiles": 99, "decode_compiles": 1}}))
    rc = cli.main(["--config", "smollm-135m", "--reduced",
                   "--max-batch", "2", "--max-len", "32",
                   "--page-size", "8", "--prefill-chunk", "8",
                   "--check-bench", str(bench), "--out", "-"])
    assert rc == 1


BENCH_ENGINE = {"family": "dense", "allocator": "paged", "bucketed": True,
                "max_batch": 4, "max_len": 64, "page_size": 8,
                "prefill_chunk": 8, "pages_per_slot": 8,
                "prefix_cache": True}
BENCH_DOCS = [
    {"paged": {"engine": BENCH_ENGINE, "prefill_compiles": 3,
               "decode_compiles": 4}},
    {"paged": {"engine": BENCH_ENGINE, "prefill_compiles": 99,
               "decode_compiles": 4}},
    {"paged": {"engine": BENCH_ENGINE, "prefill_compiles": 4,
               "decode_compiles": 5},
     "contiguous": {"engine": dict(BENCH_ENGINE, allocator="contiguous",
                                   pages_per_slot=None,
                                   prefix_cache=False),
                    "prefill_compiles": 4, "decode_compiles": 2},
     "meta": {"note": "no engine: skipped"}, "wall_s": 1.5},
    {"rwkv": {"engine": dict(BENCH_ENGINE, family="ssm", bucketed=False,
                             allocator="contiguous", pages_per_slot=None,
                             prefix_cache=False),
              "prefill_compiles": 8, "decode_compiles": 1}},
]


@pytest.mark.parametrize("case", range(len(BENCH_DOCS)))
def test_cross_check_bench_equals_the_reference(case):
    doc = BENCH_DOCS[case]
    got = tstatic.cross_check_bench(doc)
    assert got == jstatic.cross_check_bench(doc)
    assert got["ok"] == (case in (0, 3))
    if not got["ok"]:
        assert any("SOUNDNESS BUG" in f for arm in got["arms"].values()
                   for f in arm["failures"])


@pytest.mark.parametrize("allocator", ["paged", "contiguous"])
@pytest.mark.parametrize("prefix_cache", [True, False])
def test_engine_desc_equals_the_reference_engines(engines, allocator,
                                                  prefix_cache):
    kw = dict(GEOM, allocator=allocator, prefix_cache=prefix_cache,
              tick_budget=6, warmup="decode")
    assert (tstatic.engine_desc(engines("repro_torch", **kw))
            == jstatic.engine_desc(engines("repro", **kw)))


def test_an_untraceable_signature_is_a_finding(engines, monkeypatch):
    eng = engines("repro_torch", **GEOM)
    budget = tstatic.retrace_budget(
        bucketed=True, paged=True, max_len=32, prefill_chunk=8,
        page_size=8, pages_per_slot=eng.alloc.pages_per_slot,
        prefix_cache=True)
    good = tstatic.verify_engine_signatures(eng, budget)
    assert good["verified"] and "error" not in good
    assert [s["table_width"] for s in good["decode"]] == [1, 2, 4]
    assert len({s["signature"] for s in good["decode"]}) == 3
    # the live engine is untouched: no step built, state on the CPU
    assert not eng._decode_steps and not eng._prefill_steps
    assert eng.states.kv.k.device.type == "cpu"

    def broken(self, step):
        raise RuntimeError("shape mismatch in the decode body")

    monkeypatch.setattr(tengine.Engine, "_decode_body", broken)
    bad = tstatic.verify_engine_signatures(eng, budget)
    assert not bad["verified"]
    assert "shape mismatch" in bad["error"]
