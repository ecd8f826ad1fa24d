"""The port's serve analyzer (repro_torch.analysis.serve_static) and the
engine's compile accounting, against the JAX package.

* Pass 1: the retrace-budget proof (the prefill and decode bucket
  enumerations, the chunk-resume closure, the declared budget) returns
  the reference's dict, key for key, over a grid of configs.
* Pass 2: the host-sync audit over torch's transfer surfaces finds 2 h2d
  + 1 d2h a steady decode tick in the port's engine, rejects an untagged
  site, and finds no transfer on the telemetry emit path.
* The engine: its ``retrace_budget()`` equals the reference engine's; a
  compile count forced over the budget raises at drain.
* The kernel registry's timed ``choose`` with an injected timer.
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
    # declared order, the refused candidate dropped, the fastest kept
    assert timed == [4, 1, 2, 8] and got.pages_per_step == 8
    d = r.decisions[("paged",) + key]
    assert d["source"] == "timed" and d["native"] is True
    # cached per shape: no second timing
    assert r.choose("paged", key, "cuda", timer=timer) == got
    assert timed == [4, 1, 2, 8]
    # an override merges onto the tuned choice
    over = r.choose("paged", key, "cuda",
                    kops.KernelChoice(block_q=64), timer=timer)
    assert over.pages_per_step == 8 and over.block_q == 64
    # ties keep the earlier candidate; a launch error raises
    r2 = kops.KernelRegistry()
    assert r2.choose("paged", key, "cuda",
                     timer=lambda c: 1.0).pages_per_step == 4

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
