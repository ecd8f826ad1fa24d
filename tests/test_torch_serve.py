"""The port's serving stack (repro_torch.serve) against the JAX package.

* Host side: the allocator, prefix-index and scheduler scenarios of
  tests/test_prefix_cache.py, tests/test_serve_paged.py and
  tests/test_scheduler.py replayed on both packages; each scenario
  records what it observes and both packages must observe the same.
* Engine: greedy tokens from the port's engine equal the JAX package's
  sequential greedy decode (as conftest.py::greedy_ref, jitted) for both
  mechanisms, across paged/contiguous slots, whole/chunked (tick_budget)
  admission, the prefix cache on/off and every warm-up policy, with
  shared prompt prefixes so the cache actually mounts pages.  Greedy
  tokens are compared exactly; the static steps built never exceed the
  proven retrace budget (a "serve" warm-up builds exactly the proven
  ones).  On the CPU each step runs its body eagerly: the graphs' replays
  are held against the eager step on the card, in
  tests/test_torch_serve_cuda.py.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as jtfm
from repro.models.registry import get_model as jax_model
from repro.nn.module import unbox
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import Engine, EngineConfig, Request

# full float32 matmuls and convolutions on a card (TF32 keeps ~3 digits)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SMALL = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=128)
PACKAGES = ("repro", "repro_torch")


def _serve(pkg):
    return (importlib.import_module(f"{pkg}.serve.kvcache"),
            importlib.import_module(f"{pkg}.serve.prefix"),
            importlib.import_module(f"{pkg}.serve.scheduler"))


def _take(al, rid, n):
    slot = al.claim(rid)
    assert al.ensure(slot, n) is True
    return slot, al.held(slot)


def _pool_state(al):
    free = sorted(al.free)
    referenced = [p for p in range(1, al.num_pages) if al.ref[p] > 0]
    assert sorted(free + referenced) == list(range(1, al.num_pages))
    return al.pages_in_use, free


def scenario_index_match(pkg, obs):
    kv, px, _ = _serve(pkg)
    al = kv.PagedAllocator(max_batch=2, max_len=64, page_size=4)
    idx = px.PrefixIndex(al)
    obs.append(idx.match([1, 2, 3, 4, 5]))
    slot, pages = _take(al, 0, 12)
    toks = np.arange(100, 112)
    obs.append(idx.insert(toks, pages))
    al.release(slot)
    obs.append(_pool_state(al))
    obs += [idx.match(toks), idx.match(list(toks[:9]) + [7, 7, 7]),
            idx.match([100, 7, 7, 7, 7]), idx.match(toks[:3])]


def scenario_index_split_and_share(pkg, obs):
    kv, px, _ = _serve(pkg)
    al = kv.PagedAllocator(max_batch=2, max_len=64, page_size=4)
    idx = px.PrefixIndex(al)
    s0, pa = _take(al, 0, 12)
    a = np.asarray([9] * 8 + [1, 2, 3, 4])
    idx.insert(a, pa)
    al.release(s0)
    s1, pb = _take(al, 1, 12)
    b = np.asarray([9] * 8 + [5, 6, 7, 8])
    obs.append(idx.insert(b, pb))
    al.release(s1)
    obs += [idx.cached_pages, _pool_state(al), idx.match(a), idx.match(b)]


def scenario_lru_eviction(pkg, obs):
    kv, px, _ = _serve(pkg)
    al = kv.PagedAllocator(max_batch=2, max_len=64, page_size=4)
    idx = px.PrefixIndex(al)
    for rid, tok in ((0, 1), (1, 2)):
        s, pages = _take(al, rid, 8)
        idx.insert(np.asarray([tok] * 8), pages)
        al.release(s)
    idx.match(np.asarray([1] * 8))
    obs += [idx.evict(1), idx.evictions,
            idx.match(np.asarray([2] * 8), touch=False),
            idx.match(np.asarray([1] * 8), touch=False),
            _pool_state(al), idx.clear(), al.pages_in_use]


def scenario_eviction_keeps_mounted_pages(pkg, obs):
    kv, px, _ = _serve(pkg)
    al = kv.PagedAllocator(max_batch=2, max_len=64, page_size=4)
    idx = px.PrefixIndex(al)
    s0, pages = _take(al, 0, 8)
    idx.insert(np.arange(8), pages)
    al.release(s0)
    slot = al.claim(1)
    al.map_shared(slot, pages[:2])
    obs += [idx.evict(1), idx.cached_pages, al.pages_in_use]
    al.release(slot)
    obs.append(_pool_state(al))


def scenario_fork_and_release(pkg, obs):
    kv, _, _ = _serve(pkg)
    al = kv.PagedAllocator(max_batch=2, max_len=32, page_size=8)
    s0, pages = _take(al, 0, 16)
    for p in pages:
        al.addref(p)
    al.release(s0)
    s1 = al.claim(1)
    al.map_shared(s1, pages)
    obs += [[int(al.ref[p]) for p in pages], al.writable(s1, 0)]
    old, new = al.fork(s1, 0)
    obs += [old == pages[0], al.writable(s1, 0), int(al.ref[old]),
            al.held(s1) == [new, pages[1]]]
    al.ensure(s1, 24)
    al.release(s1)
    obs.append(al.pages_in_use)
    for p in pages:
        al.decref(p)
    obs.append(_pool_state(al))
    with pytest.raises(RuntimeError, match="double-freed"):
        al.decref(pages[0])


def scenario_reclaimer_and_trash_page(pkg, obs):
    kv, _, _ = _serve(pkg)
    al = kv.PagedAllocator(max_batch=2, max_len=32, page_size=8, num_pages=3)
    s0, pages = _take(al, 0, 16)
    for p in pages:
        al.addref(p)
    al.release(s0)
    calls = []

    def reclaim(n):
        calls.append(n)
        return sum(al.decref(p) for p in pages)

    al.attach_reclaimer(reclaim)
    s1 = al.claim(1)
    obs += [al.ensure(s1, 16), calls]
    al.release(s1)
    obs.append(_pool_state(al))
    with pytest.raises(ValueError, match="trash page"):
        al.addref(0)


def scenario_paged_allocator_growth_and_exhaustion(pkg, obs):
    kv, _, _ = _serve(pkg)
    al = kv.PagedAllocator(max_batch=3, max_len=32, page_size=8,
                           num_pages=5)
    a = al.claim(10)
    obs += [al.ensure(a, 9), al.ensure(a, 16), al.block_tables.tolist()]
    b = al.claim(11)
    obs += [al.ensure(b, 24), al.high_water_pages, al.pages_in_use]
    al.release(a)
    obs += [al.active(), al.lengths().tolist(), al.free,
            al.block_tables.tolist()]
    s = kv.SlotAllocator(2)
    obs += [s.claim(1), s.claim(2), s.claim(3)]


def scenario_schedulers(pkg, obs):
    _, _, sch = _serve(pkg)

    class Req:
        def __init__(self, i, priority=0, prompt=(1, 2, 3)):
            self.request_id, self.priority, self.arrival = i, priority, i
            self.prompt = list(prompt)

    for cls in (sch.FIFOScheduler, sch.PriorityScheduler):
        s = cls()
        for i, prio in enumerate((0, 5, 1, 5)):
            s.add(Req(i, prio))
        order = []
        while len(s):
            r = s.next(None)
            s.remove(r)
            order.append(r.request_id)
        obs.append(order)

    class Index:
        class root:
            children = {(42,) * 8: object()}

        def match(self, prompt, touch=True):
            return (8 if prompt[0] == 42 else 0), []

    class Eng:
        prefix = Index()

    s = sch.PrefixAffinityScheduler()
    s.add(Req(0, prompt=[7] * 8))
    s.add(Req(1, prompt=[42] * 8))
    obs.append(s.next(Eng()).request_id)
    obs.append(sorted(sch.SCHEDULERS))
    with pytest.raises(ValueError, match="unknown scheduler"):
        sch.make_scheduler("nope")


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_index_match, scenario_index_split_and_share,
    scenario_lru_eviction, scenario_eviction_keeps_mounted_pages,
    scenario_fork_and_release, scenario_reclaimer_and_trash_page,
    scenario_paged_allocator_growth_and_exhaustion, scenario_schedulers)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_host_scenarios_observe_the_same_on_both_packages(name):
    seen = {}
    for pkg in PACKAGES:
        seen[pkg] = []
        SCENARIOS[name](pkg, seen[pkg])
    assert repr(seen["repro_torch"]) == repr(seen["repro"])


# ---------------------------------------------------------------------------
# engine greedy parity
# ---------------------------------------------------------------------------

def _prompts():
    """Five prompts, page size 8: #2 shares 16 tokens with #0 and #3
    repeats #0, so a finished #0 gives later admissions a prefix credit."""
    rng = np.random.default_rng(3)
    p0 = rng.integers(0, 128, (20,))
    p1 = rng.integers(0, 128, (11,))
    p2 = np.concatenate([p0[:16], rng.integers(0, 128, (5,))])
    p4 = np.concatenate([p1[:8], rng.integers(0, 128, (5,))])
    return [p.astype(np.int32) for p in (p0, p1, p2, p0.copy(), p4)]


N_NEW = 5


@functools.lru_cache(maxsize=None)
def _reference(mech):
    """(port cfg, port params, JAX sequential greedy tokens per prompt)."""
    jcfg = jax_config(f"smollm-135m@{mech}").reduced(**SMALL)
    tcfg = get_config(f"smollm-135m@{mech}").reduced(**SMALL)
    japi = jax_model(jcfg)
    jp = unbox(jax.jit(japi.init)(jax.random.PRNGKey(0)))
    step = jax.jit(japi.step)
    outs = []
    for prompt in _prompts():
        states = jtfm.init_states(jcfg, 1, 64, per_slot=True)
        logits, states = step(jp, jnp.asarray(prompt)[None], states, None)
        out = [int(jnp.argmax(logits[0, -1]))]
        while len(out) < N_NEW:
            logits, states = step(
                jp, jnp.asarray([[out[-1]]], dtype=jnp.int32), states, None)
            out.append(int(jnp.argmax(logits[0, -1])))
        outs.append(out)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return tcfg, tp, outs


@pytest.mark.parametrize("mech", ["dotprod", "inhibitor"])
@pytest.mark.parametrize("allocator", ["paged", "contiguous"])
@pytest.mark.parametrize("tick_budget", [None, 8])
@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("warmup", ["none", "decode", "serve"])
def test_engine_greedy_matches_jax_sequential_decode(mech, allocator,
                                                     tick_budget,
                                                     prefix_cache, warmup):
    tcfg, tp, ref = _reference(mech)
    eng = Engine(get_model(tcfg), tp,
                 EngineConfig(max_batch=2, max_len=64, allocator=allocator,
                              page_size=8, prefill_chunk=8,
                              tick_budget=tick_budget,
                              prefix_cache=prefix_cache, warmup=warmup),
                 device="cpu")
    # warm-up leaves the state as it found it, and the state's tensors
    # stay the engine's for its life (every edit lands in place)
    state = list(eng.states.kv)
    assert not state[-1].any()
    if allocator == "paged":
        assert not eng.states.kv.block_tables.any()
    reqs = [Request(i, p, max_new_tokens=N_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    done = eng.run_to_completion()
    assert len(done) == len(reqs)
    assert [r.output for r in reqs] == ref
    assert all(a is b for a, b in zip(eng.states.kv, state))
    stats = eng.stats()
    hits = stats["prefix_hit_tokens"]
    assert (hits > 0) == (allocator == "paged" and prefix_cache)
    if tick_budget is not None:
        assert stats["prefill_chunks"] > len(reqs)
    if allocator == "paged":
        assert stats["pages_in_use"] == stats["cached_pages"]
    # compile counts: never above the proven budget; a warm engine built
    # the whole proven ladder up front; the CPU captures no graph
    b = stats["retrace_budget"]
    assert stats["decode_compiles"] <= b["decode_proven"]
    assert stats["prefill_compiles"] <= b["prefill_proven"]
    if warmup != "none":
        assert stats["decode_compiles"] == b["decode_proven"]
    if warmup == "serve":
        assert stats["prefill_compiles"] == b["prefill_proven"]
    g = stats["graphs"]
    assert g["captures"] == g["replays"] == 0
    assert g["eager_runs"] == (stats["decode_ticks"]
                               + stats["prefill_chunks"]
                               + (stats["decode_compiles"]
                                  if warmup != "none" else 0)
                               + (stats["prefill_compiles"]
                                  if warmup == "serve" else 0))


def test_engine_eos_cancel_and_hard_stop():
    """EOS on the first (prefill) token finishes at admission; a queued
    request cancels; a slot at max_len hard-stops, truncated."""
    tcfg, tp, ref = _reference("inhibitor")
    api = get_model(tcfg)
    p = _prompts()
    eng = Engine(api, tp, EngineConfig(max_batch=1, max_len=64, page_size=8),
                 device="cpu")
    first = Request(0, p[0], max_new_tokens=N_NEW, eos_id=ref[0][0])
    queued = Request(1, p[1], max_new_tokens=N_NEW)
    eng.submit(first)
    eng.submit(queued)
    assert eng.cancel(1) and queued.truncated
    assert eng.run_to_completion() == [first]
    assert first.output == [ref[0][0]]
    eng = Engine(api, tp, EngineConfig(max_batch=1, max_len=23, page_size=8),
                 device="cpu")
    long = Request(2, p[0], max_new_tokens=50)
    eng.submit(long)
    eng.run_to_completion()
    # rows 20, 21, 22 take decode writes: the prefill token plus three
    assert long.truncated and long.output == ref[0][:23 - len(p[0]) + 1]
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(3, np.zeros(23, np.int32)))


def test_engine_requires_a_device_it_can_use():
    tcfg, tp, _ = _reference("dotprod")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(get_model(tcfg), tp, EngineConfig())
