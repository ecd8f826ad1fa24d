"""The MoE and hybrid families served through the port's engine
(repro_torch.serve.engine) against the JAX package's engine on the same
requests and converted parameters.

* Models: ``qwen2-moe-a2.7b`` and ``hymba-1.5b`` reduced (2 layers, d
  32, d_ff 64, vocab 128; 4 experts of 32, top 2, a gated shared expert;
  Mamba inner 64, state 8), hymba with ``sliding_window`` 8 on both
  sides so the window bites in decode, its branch scales and Mamba
  biases drawn from a numpy seed; converted through
  ``convert.params_from_jax``.
* Engine geometry: paged, max_batch 2, max_len 64, page 8, prefill chunk
  8, 3 requests, so a slot is recycled.  The MoE requests share a
  16-token prefix, so the third mounts the first's cached pages.
* Greedy tokens of the port's engine equal the reference engine's under
  every warm-up policy; exactly (MoE capacity ties the rows of a batch:
  both engines feed padding rows the same tokens, so both route alike).
* qwen2-moe serves as dense does: bucketed, paged, the prefix cache on
  and hit.  hymba is paged, unbucketed, with no prefix cache (asked for,
  refused and logged), its prompts prefilled in exact-length chunks; a
  tick budget is ignored.  ``engine_desc``, the retrace budget and the
  live step counts equal the reference engine's.
* hymba's carries: admission zeroes the slot's Mamba rows in place; a
  second wave whose first request repeats the first prompt in a recycled
  slot reproduces its tokens; every state tensor (KV pools, cursors,
  tables, ``ssm``, ``conv``) keeps its storage across the waves.
* The launchers: ``launch.serve`` serves both families on the CPU (exit
  0), ``launch.train`` trains the reduced qwen2-moe (its loss with the
  aux terms, finite).  Where the launchers stand on the encoder-decoder
  and vlm ids: tests/test_torch_vlm.py.
"""

import dataclasses
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
from repro_torch.models.registry import get_model
from repro_torch.serve import engine as tengine

SMALL = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=128)
GEOM = dict(max_batch=2, max_len=64, page_size=8, prefill_chunk=8)
PROMPTS = {"qwen2-moe-a2.7b": (21, 18, 27), "hymba-1.5b": (19, 5, 12)}
NEW = (6, 9, 5)
SHARED = {"qwen2-moe-a2.7b": 16, "hymba-1.5b": 0}
WINDOW = 8


def _cfg(get, arch):
    cfg = get(arch).reduced(**SMALL)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, sliding_window=WINDOW))
    return cfg


def _live(jp, seed=0):
    rng = np.random.default_rng(seed)
    blocks = dict(jp["blocks"])
    if "mamba" in blocks:
        m = dict(blocks["mamba"])
        m["conv_b"] = rng.normal(size=m["conv_b"].shape).astype(np.float32)
        m["dt_proj"] = dict(m["dt_proj"], bias=(0.5 * rng.normal(
            size=m["dt_proj"]["bias"].shape) - 1.0).astype(np.float32))
        blocks["mamba"] = m
        blocks["branch_scale"] = rng.uniform(
            0.5, 1.5, blocks["branch_scale"].shape).astype(np.float32)
    return dict(jp, blocks=blocks)


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = _cfg(jax_config, arch)
    japi = jax_model(jcfg)
    jp = _live(jax.tree.map(np.asarray, unbox(japi.init(
        jax.random.PRNGKey(0)))))
    tcfg = _cfg(get_config, arch)
    tparams = params_from_jax(jp, tcfg, device="cpu")
    return japi, jax.tree.map(jax.numpy.asarray, jp), get_model(tcfg), tparams


def _requests(mod, arch, wave=0):
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 128, (SHARED[arch],)).astype(np.int32)
    out = []
    for i, (n, m) in enumerate(zip(PROMPTS[arch], NEW)):
        tail = rng.integers(0, 128, (n - len(shared),)).astype(np.int32)
        out.append(mod.Request(wave * 10 + i, np.concatenate([shared, tail]),
                               max_new_tokens=m))
    return out


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [r.output for r in reqs]


@functools.lru_cache(maxsize=None)
def _reference(arch):
    japi, jparams, _, _ = _models(arch)
    eng = jengine.Engine(japi, jparams, jengine.EngineConfig(**GEOM))
    tokens = _serve(eng, _requests(jengine, arch))
    return (tokens, eng.prefill_compiles, eng.decode_compiles,
            jstatic.engine_desc(eng), eng.retrace_budget(),
            eng.counters["prefix_hit_tokens"])


def _port(arch, **kw):
    _, _, api, params = _models(arch)
    return tengine.Engine(api, params,
                          tengine.EngineConfig(**dict(GEOM, **kw)),
                          device="cpu")


@pytest.mark.parametrize("warmup", ["none", "decode", "serve"])
@pytest.mark.parametrize("arch", sorted(PROMPTS))
def test_greedy_tokens_equal_the_reference_engine(arch, warmup):
    tokens, *_ = _reference(arch)
    eng = _port(arch, warmup=warmup)
    got = _serve(eng, _requests(tengine, arch))
    assert got == tokens
    assert [len(t) for t in got] == list(NEW)
    assert eng.paged and eng.decode_plan is not None
    assert eng.stats()["graphs"]["captures"] == 0        # the CPU


@pytest.mark.parametrize("arch", sorted(PROMPTS))
def test_engine_desc_budget_and_steps_equal_the_reference(arch):
    tokens, prefill, decode, desc, budget, hits = _reference(arch)
    eng = _port(arch)
    assert _serve(eng, _requests(tengine, arch)) == tokens
    assert tstatic.engine_desc(eng) == desc
    assert eng.retrace_budget() == budget
    assert (eng.prefill_compiles, eng.decode_compiles) == (prefill, decode)
    assert eng.counters["prefix_hit_tokens"] == hits
    if arch.startswith("qwen2-moe"):
        assert eng._bucketed and eng.prefix is not None and hits > 0
    else:
        assert not eng._bucketed and eng.prefix is None and hits == 0
        # exact-length chunks: 19 = 8 + 8 + 3, 5, 12 = 8 + 4
        assert sorted(eng._prefill_steps) == [3, 4, 5, 8]


def test_hybrid_refuses_the_prefix_cache_and_tick_budget(caplog):
    with caplog.at_level(logging.INFO, logger="repro_torch.serve"):
        eng = _port("hymba-1.5b", tick_budget=4)
    msgs = " | ".join(r.getMessage() for r in caplog.records)
    assert "prefix cache unavailable for family 'hybrid'" in msgs
    assert "tick_budget ignored" in msgs
    assert eng.paged and eng.prefix is None


def test_hybrid_slots_reset_in_place_and_recycle():
    arch = "hymba-1.5b"
    tokens, *_ = _reference(arch)
    eng = _port(arch)
    st = eng.states
    reqs = _requests(tengine, arch)
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert sorted(eng.active) == [0, 1]
    ssm, conv = st.ssm.clone(), st.conv.clone()
    assert all(bool(x[:, s].abs().sum() > 0)
               for x in (ssm, conv) for s in (0, 1))
    eng._reset_slot(0)
    for live, before in ((st.ssm, ssm), (st.conv, conv)):
        assert torch.count_nonzero(live[:, 0]) == 0
        assert torch.equal(live[:, 1], before[:, 1])
    assert int(st.kv.length[0]) == 0
    # a fresh engine for the waves: the first wave, then the first prompt
    # again in the recycled slot
    eng = _port(arch)
    st = eng.states
    tensors = [st.kv.k, st.kv.v, st.kv.length, st.kv.block_tables, st.ssm,
               st.conv]
    ptrs = [t.data_ptr() for t in tensors]
    assert _serve(eng, _requests(tengine, arch)) == tokens
    wave = _requests(tengine, arch, wave=1)
    wave[0] = tengine.Request(100, _requests(tengine, arch)[0].prompt,
                              max_new_tokens=NEW[0])
    assert _serve(eng, wave)[0] == tokens[0]
    st = eng.states
    assert [t.data_ptr() for t in (st.kv.k, st.kv.v, st.kv.length,
                                   st.kv.block_tables, st.ssm,
                                   st.conv)] == ptrs


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b@inhibitor", "hymba-1.5b"])
def test_serve_launcher_runs_the_families(arch):
    from repro_torch.launch import serve as launch_serve

    assert launch_serve.main(["--arch", arch, "--device", "cpu",
                              "--requests", "3", "--max-batch", "2",
                              "--max-len", "48", "--prompt-len", "12",
                              "--new-tokens", "3", "--prefill-chunk",
                              "8"]) == 0


def test_train_launcher_trains_the_moe_family():
    from repro_torch.launch import train as launch_train

    out = launch_train.run(["--arch", "qwen2-moe-a2.7b", "--device", "cpu",
                            "--steps", "3", "--batch", "2", "--seq", "16",
                            "--lr", "1e-3"])
    assert len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))
