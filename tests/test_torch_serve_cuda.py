"""The serving engine's static steps on the card: each decode and prefill
bucket's CUDA-graph replay against the eager ``api.step`` on the same
state, bit for bit, and an engine serving through its graphs against the
same engine with its steps never captured.  Every test here needs a CUDA
card and skips without one; the file imports no JAX, so it runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serve_cuda.py

The model is smollm-135m reduced (2 layers, d 64, 4 / 2 heads of 16,
float32 compute), the engine max_batch 4, max_len 64, page 8, chunk 8.
For the inhibitor wq and wk are scaled by 1/sqrt(head_dim), else every
inhibition term is 0 and the attention check would hold for zeros.
"""

import numpy as np
import pytest
import torch

from repro_torch.analysis.serve_static import (enumerate_decode_buckets,
                                               enumerate_prefill_buckets)
from repro_torch.configs import get_config
from repro_torch.core.attention import KVCache, PagedKVCache
from repro_torch.core.mechanism import kernel_family, resolve_mechanism_name
from repro_torch.kernels import ops as kops
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import LayerState
from repro_torch.serve.engine import Engine, EngineConfig, Request

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MAX_BATCH, MAX_LEN, PS, CHUNK = 4, 64, 8, 8


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and the paged kernels "
                    "have no CPU mode)")


def _model(mech):
    cfg = get_config(f"smollm-135m@{mech}").reduced()
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cuda")
    if mech == "inhibitor":
        for blk in params["blocks"]:
            for w in ("wq", "wk"):
                blk["attn"][w]["kernel"].mul_(cfg.attention.head_dim ** -0.5)
    return cfg, api, params


def _engine(api, params, allocator, cls=Engine, **kw):
    return cls(api, params, EngineConfig(
        max_batch=MAX_BATCH, max_len=MAX_LEN, page_size=PS,
        prefill_chunk=CHUNK, allocator=allocator, **kw), device="cuda")


def _fill(eng, seed):
    """Random pools / caches, distinct pages per row, random cursors."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kv = eng.states.kv
    kv.k.copy_(torch.randn(kv.k.shape, generator=g, device="cuda"))
    kv.v.copy_(torch.randn(kv.v.shape, generator=g, device="cuda"))
    if eng.paged:
        P = kv.block_tables.shape[1]
        kv.block_tables.copy_(1 + torch.arange(
            MAX_BATCH * P, device="cuda", dtype=torch.int32).reshape(
                MAX_BATCH, P))
    return g


def _snapshot(kv):
    return [t.clone() for t in kv]


def _restore(kv, snap):
    for t, s in zip(kv, snap):
        t.copy_(s)


@pytest.mark.cuda
@pytest.mark.parametrize("allocator", ["paged", "contiguous"])
@pytest.mark.parametrize("mech", ["inhibitor", "dotprod"])
def test_decode_graph_replays_equal_the_eager_step(mech, allocator):
    _needs_card()
    cfg, api, params = _model(mech)
    eng = _engine(api, params, allocator)
    kv = eng.states.kv
    widths = (enumerate_decode_buckets(max_len=MAX_LEN, page_size=PS,
                                       pages_per_slot=MAX_LEN // PS)
              if eng.paged else ["contiguous"])
    for n, hw in enumerate(widths):
        g = _fill(eng, n)
        top = hw * PS if eng.paged else MAX_LEN
        kv.length.copy_(torch.randint(0, top, (MAX_BATCH,), generator=g,
                                      device="cuda", dtype=torch.int32))
        tokens = torch.randint(0, cfg.vocab_size, (MAX_BATCH, 1),
                               generator=g, device="cuda",
                               dtype=torch.int32)
        snap = _snapshot(kv)
        step = eng._decode_step_for(hw)
        step.tokens.copy_(tokens)
        step()                          # eager (and tuned), then captured
        assert step.graph is not None and step.runs == 1
        _restore(kv, snap)
        ref = [t.clone() for t in snap]
        if eng.paged:
            ref[2] = ref[2][:, :hw].contiguous()
        ref_kv = type(kv)(*ref)
        logits, new = api.step(params, tokens, LayerState(kv=ref_kv), None)
        step()                          # the replay
        assert step.replays == 1
        assert torch.equal(step.out, logits[:, -1])
        assert torch.equal(kv.k, ref_kv.k) and torch.equal(kv.v, ref_kv.v)
        assert torch.equal(kv.length, new.kv.length)
        if eng.paged:
            assert torch.equal(kv.block_tables, snap[2])
            family = kernel_family(resolve_mechanism_name(cfg.attention))
            key = ("paged", family, hw, PS, cfg.attention.num_heads,
                   cfg.attention.num_kv_heads, cfg.attention.head_dim)
            assert kops.registry.decisions[key]["source"] == "timed"
            fam = ("paged_inhibitor" if mech == "inhibitor"
                   else "paged_attention")
            assert step.captured == {fam: cfg.num_layers}


@pytest.mark.cuda
@pytest.mark.parametrize("allocator", ["paged", "contiguous"])
@pytest.mark.parametrize("mech", ["inhibitor", "dotprod"])
def test_prefill_graph_replays_equal_the_eager_step(mech, allocator):
    _needs_card()
    cfg, api, params = _model(mech)
    eng = _engine(api, params, allocator)
    kv = eng.states.kv
    slot = 2
    for n, cb in enumerate(enumerate_prefill_buckets(
            max_len=MAX_LEN, prefill_chunk=CHUNK, bucketed=True,
            page_size=PS if eng.paged else None, prefix_cache=eng.paged)):
        g = _fill(eng, 10 + n)
        start = int(torch.randint(0, MAX_LEN - cb + 1, (1,), generator=g,
                                  device="cuda"))
        tokens = torch.randint(0, cfg.vocab_size, (1, cb), generator=g,
                               device="cuda", dtype=torch.int32)
        snap = _snapshot(kv)
        step = eng._prefill_step_for(cb)

        def stage():
            step.tokens.copy_(tokens)
            step.cursor.fill_(start)
            if eng.paged:
                step.table.copy_(kv.block_tables[slot:slot + 1])
            else:
                step.slot.fill_(slot)

        stage()
        step()
        assert step.graph is not None
        _restore(kv, snap)
        k, v = snap[0].clone(), snap[1].clone()
        cursor = torch.full((1,), start, dtype=torch.int32, device="cuda")
        if eng.paged:
            view = PagedKVCache(k, v, snap[2][slot:slot + 1].clone(), cursor)
        else:
            view = KVCache(k[:, slot:slot + 1], v[:, slot:slot + 1], cursor)
        logits, new = api.step(params, tokens, LayerState(kv=view), None)
        stage()
        step()
        assert step.replays == 1
        assert torch.equal(step.out, logits)
        assert torch.equal(kv.k, k) and torch.equal(kv.v, v)
        assert torch.equal(step.cursor, new.kv.length)
        assert torch.equal(kv.length, snap[-1])


class _NeverCaptured(Engine):
    """The same engine with its static steps run eagerly every time: the
    yardstick the graphs are held against."""

    def _capture(self, step):
        return None


@pytest.mark.cuda
@pytest.mark.parametrize("warmup", ["none", "serve"])
@pytest.mark.parametrize("mech", ["inhibitor", "dotprod"])
def test_engine_serves_through_graphs_like_its_eager_steps(mech, warmup):
    _needs_card()
    cfg, api, params = _model(mech)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 17, 30, 41, 9, 23)]
    outs = {}
    for cls in (Engine, _NeverCaptured):
        eng = _engine(api, params, "paged", cls=cls, tick_budget=16,
                      warmup=warmup)
        built = (eng.decode_compiles, eng.prefill_compiles)
        reqs = [Request(i, p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        kops.reset_counts()
        eng.run_to_completion()
        outs[cls] = [r.output for r in reqs]
        s = eng.stats()
        g = s["graphs"]
        fam = "paged_inhibitor" if mech == "inhibitor" else "paged_attention"
        counts = kops.counts()
        # a 1-token prefill chunk is single-query: it runs the paged
        # kernel too (the warm-up's own run came before the reset)
        one = eng._prefill_steps.get(1)
        ones = 0 if one is None else one.runs + one.replays - (
            warmup == "serve")
        assert counts[fam] == (s["decode_ticks"] + ones) * cfg.num_layers
        assert counts[fam + "_plain"] == 0
        if cls is _NeverCaptured:
            assert g["captures"] == g["replays"] == 0
            continue
        assert g["captures"] == s["decode_compiles"] + s["prefill_compiles"]
        # every tick at a seen bucket is a replay
        first_runs = s["decode_compiles"] - (built[0] if warmup != "none"
                                             else 0)
        assert g["decode_replays"] == s["decode_ticks"] - first_runs
        if warmup == "serve":
            assert (s["decode_compiles"], s["prefill_compiles"]) == built
            assert g["replayed_launches"][fam] == counts[fam]
        assert s["decode_compiles"] <= s["retrace_budget"]["decode_proven"]
    assert outs[Engine] == outs[_NeverCaptured]
