"""RWKV-6 served through the port's engine (repro_torch.serve.engine, the
``ssm`` family) against the JAX package's engine on the same requests and
converted parameters.

* Model: ``rwkv6-7b`` reduced (2 layers, d 64, 4 WKV heads of 16, lora
  8), the reference's init with every term init leaves zero or constant
  (u, the token-shift mixes and LoRAs, the decay, the group norm) drawn
  from a numpy seed, so the recurrence is live; converted through
  ``convert.params_from_jax``.
* Greedy tokens of the port's engine equal the reference engine's for
  both allocators asked (both fall back to contiguous slots: the family
  has no KV cache), with every warm-up policy, and with a tick budget
  (logged as ignored: whole prompts prefill at admission).  max_batch 2
  against 5 requests, so slots are recycled; prompt lengths cross the
  chunk width 8, so prompts prefill in exact-length chunks through the
  carried state.  Tokens are compared exactly.
* The per-slot state: admission zeroes the slot's rows in place and
  leaves the other slots' rows and every tensor's storage as they were;
  a request re-admitted into a recycled slot reproduces its tokens from
  a fresh engine.
* ``engine_desc``, ``retrace_budget()`` (the proof marks the family
  unbucketed: prefill proven > declared) and the live step counts equal
  the reference engine's key for key; the engine has no decode plan, no
  prefix cache, and runs no WKV kernel (0 ``wkv6`` launches, 0 plain
  chunked calls: the exact scan, as the reference).
* ``launch.serve --arch rwkv6-7b --device cpu`` exits 0.
"""

import functools
import logging

import jax
import numpy as np
import pytest
import torch

from repro.analysis import serve_static as jstatic
from repro.configs import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.nn.module import unbox
from repro.serve import engine as jengine
from repro_torch.analysis import serve_static as tstatic
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops as kops
from repro_torch.models.registry import get_model
from repro_torch.serve import engine as tengine

ARCH = "rwkv6-7b"
GEOM = dict(max_batch=2, max_len=32, page_size=8, prefill_chunk=8)
PROMPTS = (3, 11, 7, 17, 1)
NEW = (5, 3, 6, 2, 4)


def _live(jp, seed=0):
    """The reference tree with every RWKV term that init leaves zero (or
    constant) drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    blocks = jax.tree.map(np.asarray, jp["blocks"])
    tm, cm = dict(blocks["time_mix"]), dict(blocks["channel_mix"])

    def draw(a, loc, scale):
        return (loc + scale * rng.normal(size=a.shape)).astype(np.float32)

    tm["u"] = draw(tm["u"], 0.0, 0.5)
    tm["mu_base"] = rng.uniform(size=tm["mu_base"].shape).astype(np.float32)
    for name in ("mix_lora_a", "mix_lora_b", "w_lora_a", "w_lora_b"):
        tm[name] = draw(tm[name], 0.0, 0.3)
    tm["w_base"] = draw(tm["w_base"], -1.0, 1.0)
    tm["ln_x"] = {"scale": draw(tm["ln_x"]["scale"], 1.0, 0.2),
                  "bias": draw(tm["ln_x"]["bias"], 0.0, 0.2)}
    cm["mu_k"] = rng.uniform(size=cm["mu_k"].shape).astype(np.float32)
    cm["mu_r"] = rng.uniform(size=cm["mu_r"].shape).astype(np.float32)
    blocks = dict(blocks, time_mix=tm, channel_mix=cm)
    return dict(jax.tree.map(np.asarray, jp), blocks=blocks)


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = jax_config(ARCH).reduced()
    japi = jax_model(jcfg)
    jp = _live(unbox(japi.init(jax.random.PRNGKey(0))))
    tcfg = get_config(ARCH).reduced()
    tparams = params_from_jax(jp, tcfg, device="cpu")
    jparams = jax.tree.map(jax.numpy.asarray, jp)
    return japi, jparams, get_model(tcfg), tparams, tcfg


def _requests(mod, vocab, prompts=PROMPTS, new=NEW):
    rng = np.random.default_rng(3)
    return [mod.Request(i, rng.integers(0, vocab, (n,)).astype(np.int32),
                        max_new_tokens=m)
            for i, (n, m) in enumerate(zip(prompts, new))]


def _port_engine(**kw):
    _, _, api, params, _ = _models()
    return tengine.Engine(api, params,
                          tengine.EngineConfig(**dict(GEOM, **kw)),
                          device="cpu")


@functools.lru_cache(maxsize=None)
def _reference(allocator):
    japi, jparams, _, _, tcfg = _models()
    eng = jengine.Engine(japi, jparams,
                         jengine.EngineConfig(allocator=allocator, **GEOM))
    reqs = _requests(jengine, tcfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return ([r.output for r in reqs], eng.prefill_compiles,
            eng.decode_compiles, jstatic.engine_desc(eng),
            eng.retrace_budget())


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [r.output for r in reqs]


@pytest.mark.parametrize("warmup", ["none", "decode", "serve"])
@pytest.mark.parametrize("allocator", ["paged", "contiguous"])
def test_greedy_tokens_equal_the_reference_engine(allocator, warmup):
    tokens, *_ = _reference(allocator)
    eng = _port_engine(allocator=allocator, warmup=warmup)
    assert not eng.paged and eng.prefix is None
    assert eng.decode_plan is None
    kops.reset_counts()
    got = _serve(eng, _requests(tengine, _models()[4].vocab_size))
    assert got == tokens
    assert [len(t) for t in got] == list(NEW)
    counts = kops.counts()
    assert counts["wkv6"] == 0 and counts["wkv6_plain"] == 0, counts
    assert eng.stats()["graphs"]["captures"] == 0        # the CPU


def test_tick_budget_is_ignored_and_logged(caplog):
    tokens, *_ = _reference("contiguous")
    with caplog.at_level(logging.INFO, logger="repro_torch.serve"):
        eng = _port_engine(allocator="paged", tick_budget=2)
    msgs = " | ".join(r.getMessage() for r in caplog.records)
    assert "no pageable KV cache" in msgs
    assert "tick_budget ignored" in msgs
    reqs = _requests(tengine, _models()[4].vocab_size)
    for r in reqs:
        eng.submit(r)
    ticks = []
    while eng.active or eng.admitting or len(eng.scheduler):
        eng.step()
        # whole prompts at admission: no partial survives a tick
        ticks.append(len(eng.admitting))
    assert set(ticks) == {0}
    assert [r.output for r in reqs] == tokens


@pytest.mark.parametrize("allocator", ["paged", "contiguous"])
def test_engine_desc_retrace_and_step_counts_equal_the_reference(allocator):
    tokens, prefill, decode, desc, budget = _reference(allocator)
    eng = _port_engine(allocator=allocator)
    _serve(eng, _requests(tengine, _models()[4].vocab_size))
    assert tstatic.engine_desc(eng) == desc
    assert eng.retrace_budget() == budget
    assert not budget["within_declared"]
    assert (eng.prefill_compiles, eng.decode_compiles) == (prefill, decode)
    # one step per distinct exact width: 3, 8 (11 = 8 + 3; 17 = 8 + 8 +
    # 1), 7 and 1
    assert sorted(eng._prefill_steps) == [1, 3, 7, 8]
    assert eng.prefill_compiles <= budget["prefill_proven"]
    full = tstatic.retrace_budget(
        bucketed=False, paged=False, max_len=GEOM["max_len"],
        prefill_chunk=GEOM["prefill_chunk"], prefix_cache=False)
    assert full == jstatic.retrace_budget(
        bucketed=False, paged=False, max_len=GEOM["max_len"],
        prefill_chunk=GEOM["prefill_chunk"], prefix_cache=False)
    assert full["prefill"]["proven"] > full["prefill"]["declared"]


def test_admission_zeroes_the_slot_in_place():
    eng = _port_engine(allocator="contiguous")
    ptrs = [x.data_ptr() for x in eng.states]
    vocab = _models()[4].vocab_size
    reqs = _requests(tengine, vocab, prompts=(9, 5), new=(4, 3))
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert sorted(eng.active) == [0, 1]
    before = [x.clone() for x in eng.states]
    assert all(x[:, 0].abs().sum() > 0 for x in before)
    eng._reset_slot(0)
    for x, b in zip(eng.states, before):
        assert torch.count_nonzero(x[:, 0]) == 0
        assert torch.equal(x[:, 1], b[:, 1])
    eng.run_to_completion()
    # the state's tensors are the engine's for its life
    assert [x.data_ptr() for x in eng.states] == ptrs


def test_a_recycled_slot_reproduces_a_fresh_slots_tokens():
    vocab = _models()[4].vocab_size
    # one slot: the third request runs in the slot the first two used,
    # with the first one's prompt
    eng = _port_engine(allocator="contiguous", max_batch=1)
    reqs = _requests(tengine, vocab, prompts=(11, 6), new=(6, 5))
    again = tengine.Request(9, reqs[0].prompt.copy(), max_new_tokens=6)
    got = _serve(eng, reqs + [again])
    assert got[2] == got[0]
    fresh = _port_engine(allocator="contiguous", max_batch=1)
    solo = tengine.Request(0, reqs[0].prompt.copy(), max_new_tokens=6)
    assert _serve(fresh, [solo]) == [got[0]]
    # and the reference engine, as it runs the same traffic
    japi, jparams, *_ = _models()
    jeng = jengine.Engine(japi, jparams, jengine.EngineConfig(
        allocator="contiguous", **dict(GEOM, max_batch=1)))
    jreqs = [jengine.Request(r.request_id, r.prompt.copy(),
                             max_new_tokens=r.max_new_tokens)
             for r in reqs + [again]]
    assert _serve(jeng, jreqs) == got


def test_serve_launcher_serves_rwkv_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch_serve

    rc = launch_serve.main(["--arch", ARCH, "--device", "cpu",
                            "--requests", "3", "--max-batch", "2",
                            "--max-len", "32", "--prompt-len", "9",
                            "--new-tokens", "3", "--prefill-chunk", "8",
                            "--log-json"])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines and '"finished_total": 3' in lines[-1]
