"""The port's cost model (repro_torch.analysis.costmodel) against counts
worked out by hand: the reference's jaxpr walker cannot serve as the
oracle here (its cost-model tests fail on this jax, which lacks
``jax.core.Literal``), so each check mirrors one of
tests/test_serve_static.py's cost-model tests with the number it must
give written out.

* the walker: matmul FLOPs (2·m·n·k) and bytes exact; a gather charged
  its moved rows and the index bytes, never the pool; a scatter its
  updates and indices; a Python loop of T steps T times one step; a
  ``.item()`` / ``.tolist()`` / ``.cpu()`` counted as a host sync;
* the mm FLOPs of the reduced smollm decode step (the engine's static
  step body, walked on ``meta``) equal 2·b·(projection, MLP and logits
  weight elements) plus the attention products 2·2·b·h·n_k·d per layer;
* the H100 row and the roofline's arithmetic;
* the paged priors: fewer splits cheaper (fewer partials), ``inf`` for a
  shape the split kernel refuses or a block over the shared memory
  limit, a stable ranking; the registry times in prior order, skips
  ``inf``, times all in declared order when all are ``inf``, and lets a
  cost-model error raise.
"""

import math

import pytest
import torch

from repro_torch.analysis import costmodel as cm
from repro_torch.analysis import serve_static as tstatic
from repro_torch.configs import get_config
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged as kpaged
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import Engine, EngineConfig


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("m,k,n", [(8, 16, 4), (1, 64, 3), (5, 7, 11)])
def test_matmul_flops_and_bytes_exact(m, k, n):
    c = cm.torch_costs(lambda a, b: a @ b, meta(m, k), meta(k, n))
    assert c.flops == 2 * m * n * k
    assert c.hbm_bytes == 4 * (m * k + k * n + m * n)
    assert c.host_callbacks == 0 and c.by_op["mm"][0] == 1
    # batched: 2·B·m·n·k; a linear with bias: 2·m·n·k in the addmm
    c = cm.torch_costs(lambda a, b: a @ b, meta(3, m, k), meta(3, k, n))
    assert c.flops_of(cm.MATMUL_OPS) == 2 * 3 * m * n * k
    c = cm.torch_costs(torch.nn.functional.linear, meta(m, k), meta(n, k),
                       meta(n))
    assert c.flops_of(cm.MATMUL_OPS) == 2 * m * n * k


def test_gather_charges_moved_bytes_only():
    pool = meta(1024, 64)                                  # 256 KiB
    idx = meta(4, dtype=torch.int64)
    moved = 2 * 4 * 64 * 4 + 4 * 8                         # rows in + out
    for fn in (lambda p, i: p[i], lambda p, i: p.index_select(0, i),
               lambda p, i: torch.nn.functional.embedding(i, p)):
        c = cm.torch_costs(fn, pool, idx)
        assert c.hbm_bytes == moved
        assert c.hbm_bytes < 1024 * 64 * 4 / 8


def test_scatter_charges_updates_and_indices():
    pool, idx, upd = meta(1024, 64), meta(4, dtype=torch.int64), meta(4, 64)
    c = cm.torch_costs(lambda p, i, u: p.index_copy_(0, i, u), pool, idx,
                       upd)
    assert c.hbm_bytes == 2 * 4 * 64 * 4 + 4 * 8


def test_views_are_free_and_copies_twice_their_output():
    x = meta(8, 16)
    c = cm.torch_costs(lambda t: t.t().reshape(16, 8).unsqueeze(0), x)
    assert c.flops == 0 and c.hbm_bytes == 0
    c = cm.torch_costs(lambda t: t.t().contiguous(), x)
    assert c.hbm_bytes == 2 * 8 * 16 * 4
    c = cm.torch_costs(lambda t: t.sum(-1), x)             # a reduction
    assert c.flops == 8 * 16


def _loop(carry, xs):
    for i in range(xs.shape[0]):
        carry = carry + xs[i] * xs[i]
    return carry


@pytest.mark.parametrize("t", [1, 5, 50])
def test_a_loop_of_t_steps_costs_t_times_one_step(t):
    one = cm.torch_costs(_loop, meta(3), meta(1, 3))
    many = cm.torch_costs(_loop, meta(3), meta(t, 3))
    assert one.flops == 2 * 3
    assert many.flops == t * one.flops
    assert many.hbm_bytes == t * one.hbm_bytes
    assert many.unbounded_loops == 0


@pytest.mark.parametrize("sync", ["item", "tolist", "cpu"])
def test_host_syncs_are_counted(sync):
    def f(x):
        y = x + 1
        getattr(y.sum() if sync == "item" else y, sync)()
        return y

    assert cm.torch_costs(f, meta(3)).host_callbacks == 1
    assert cm.torch_costs(lambda x: x + 1, meta(3)).host_callbacks == 0


def test_h100_row_and_roofline_arithmetic():
    p = cm.DEFAULT_PLATFORM
    assert p is cm.H100_SXM
    assert (p.peak_flops, p.hbm_bw, p.smem_bytes) == (989e12, 3.35e12,
                                                      227 * 1024)
    assert 0 < p.dispatch_s < 1e-4
    costs = cm.Costs(flops=989e9, hbm_bytes=3.35e9)
    r = cm.roofline(costs, p, transfer_bytes=64e6)
    assert r["compute_s"] == pytest.approx(1e-3)
    assert r["memory_s"] == pytest.approx(1e-3)
    assert r["transfer_s"] == pytest.approx(1e-3)
    assert r["est_s"] == pytest.approx(2e-3)
    assert cm.roofline(cm.Costs(hbm_bytes=1.0), p)["bound"] == "memory"


# ---------------------------------------------------------------------------
# the engine's decode step, walked
# ---------------------------------------------------------------------------

SMALL = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=128)


@pytest.mark.parametrize("allocator", ["paged", "contiguous"])
def test_decode_step_mm_flops_equal_the_hand_count(allocator):
    cfg = get_config("smollm-135m").reduced(**SMALL)
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    b, max_len, ps = 2, 32, 8
    eng = Engine(api, params, EngineConfig(
        max_batch=b, max_len=max_len, page_size=ps, prefill_chunk=8,
        allocator=allocator), device="cpu")
    a = cfg.attention
    assert (a.num_heads, a.num_kv_heads, a.head_dim) == (4, 2, 16)
    assert cfg.tie_embeddings and cfg.mlp == "gated_silu"
    d, f, h, hkv, hd = cfg.d_model, cfg.d_ff, 4, 2, 16
    per_layer = (d * h * hd + 2 * d * hkv * hd + h * hd * d   # q, k, v, o
                 + 3 * d * f)                                 # gate, up, down
    weights = cfg.num_layers * per_layer + d * cfg.vocab_size  # + logits
    assert weights == 28672
    budget = eng.retrace_budget()
    widths = ([1, 2, 4] if eng.paged else ["contiguous"])
    twin = tstatic._meta_twin(eng)
    for hw in widths:
        n_k = hw * ps if eng.paged else max_len
        step = twin._build_step("decode", hw)
        costs = cm.torch_costs(step.body)
        attn = cfg.num_layers * 2 * 2 * b * h * n_k * hd      # q.k, p.v
        assert costs.flops_of(cm.MATMUL_OPS) == 2 * b * weights + attn
        assert costs.by_op["mm"][0] == 7 * cfg.num_layers + 1
        assert costs.host_callbacks == 0
    assert budget["decode_proven"] == len(widths)
    # the walk used meta tensors: the engine's own state is untouched
    assert eng.states.kv.k.device.type == "cpu" and not eng._decode_steps


# ---------------------------------------------------------------------------
# kernel priors and the registry's timed choice
# ---------------------------------------------------------------------------

KEY = ("inhibitor", 32, 16, 9, 3, 64)       # fam, width, page, h, h_kv, d


@pytest.mark.parametrize("fam", ["inhibitor", "flash"])
def test_paged_priors_rank_fewer_splits_first(fam):
    key = (fam,) + KEY[1:]
    ranked = cm.rank_kernel_candidates("paged", key,
                                       kops.CANDIDATES["paged"])
    assert [c.pages_per_step for c, _ in ranked] == [8, 4, 2, 1]
    priors = [p for _, p in ranked]
    assert priors == sorted(priors) and all(map(math.isfinite, priors))
    # the hand count at 8 pages a split: 4 splits, 2 launches
    p = cm.DEFAULT_PLATFORM
    per_split = 64 if fam == "inhibitor" else 66
    want = (2 * p.dispatch_s
            + (2 * 32 * 16 * 3 * 64 * 4 + 2 * 9 * 4 * per_split * 4)
            / p.hbm_bw + 4 * 32 * 16 * 9 * 64 / p.fp32_flops)
    assert ranked[0][1] == pytest.approx(want)
    # one split: one launch, no partials
    one = cm.kernel_prior("paged", (fam, 4, 16, 9, 3, 64),
                          kops.KernelChoice(pages_per_step=8))
    assert one == pytest.approx(p.dispatch_s + 2 * 4 * 16 * 3 * 64 * 4
                                / p.hbm_bw + 4 * 4 * 16 * 9 * 64
                                / p.fp32_flops)


@pytest.mark.parametrize("h,h_kv,d", [(9, 1, 64), (8, 2, 48)])
def test_paged_prior_is_inf_where_the_kernel_refuses(h, h_kv, d):
    key = ("inhibitor", 32, 16, h, h_kv, d)
    assert kpaged.split_refusal("inhibitor", h // h_kv, d) is not None
    ranked = cm.rank_kernel_candidates("paged", key,
                                       kops.CANDIDATES["paged"])
    assert all(p == math.inf for _, p in ranked)
    # a run of inf keeps the declared order
    assert [c for c, _ in ranked] == list(kops.CANDIDATES["paged"])


def test_paged_prior_is_inf_over_the_shared_memory_limit():
    small = cm.Platform(**dict(cm.H100_SXM.__dict__, smem_bytes=1024))
    assert kpaged.split_smem_bytes("inhibitor", 3, 64) == 4 * 4 * 4 * 64
    assert kpaged.split_smem_bytes("flash", 3, 64) == 4 * 4 * 3 * 66
    c = kops.KernelChoice(pages_per_step=4)
    assert cm.kernel_prior("paged", KEY, c, small) == math.inf
    assert math.isfinite(cm.kernel_prior("paged", KEY, c))


def test_registry_times_in_prior_order_and_skips_inf(monkeypatch):
    r = kops.KernelRegistry()
    timed = []

    def timer(c):
        timed.append(c.pages_per_step)
        return 1.0 / c.pages_per_step

    got = r.choose("paged", KEY, "cuda", timer=timer)
    assert timed == [8, 4, 2, 1] and got.pages_per_step == 8
    # a shape the kernel refuses: every prior inf, so all are timed, in
    # declared order (the wrapper's refusal then drops each)
    timed.clear()
    refused = ("inhibitor", 32, 16, 9, 1, 64)
    r.choose("paged", refused, "cuda", timer=timer)
    assert timed == [4, 1, 2, 8]
    # one candidate priced inf among finite ones is not timed
    real = cm.kernel_prior

    def prior(family, key, choice, platform=cm.DEFAULT_PLATFORM):
        if choice.pages_per_step == 8:
            return math.inf
        return real(family, key, choice, platform)

    monkeypatch.setattr(cm, "kernel_prior", prior)
    timed.clear()
    other = ("flash",) + KEY[1:]
    assert r.choose("paged", other, "cuda", timer=timer).pages_per_step == 4
    assert timed == [4, 2, 1]
    assert r.priors[("paged",) + other][-1][1] == math.inf


def test_a_cost_model_error_raises_out_of_choose(monkeypatch):
    def broken(*a, **k):
        raise ZeroDivisionError("a broken prior")

    monkeypatch.setattr(cm, "rank_kernel_candidates", broken)
    with pytest.raises(ZeroDivisionError, match="broken prior"):
        kops.KernelRegistry().choose("paged", KEY, "cuda",
                                     timer=lambda c: 1.0)
