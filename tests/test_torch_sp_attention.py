"""A whole attention under sequence parallelism computes only its rank's
query rows (``core/attention.py::query_split``), as the reference's
fused backends shard their score rows over ``model`` where the heads do
not divide (``constrain(..., ("batch", "heads", "seq_sp"))``).

(a) The training kernel entries ``kernels.ops.flash_inhibitor`` /
    ``flash_attention`` with an integer ``q_offset`` (their plain versions
    on the CPU): M = 4 query slices of one attention, each at its offset
    over every key, causal, with a window and non-causal; the outputs
    concatenated and the gradients (dq concatenated, dk and dv summed over
    the slices) against the whole call and against the JAX package's
    fused attention on the same inputs; the slices at offset 0 as a
    control; the planner's ``pallas`` backend sends an integer offset to
    the training entry, never the cached one.
(b) The sharded train step on spawned gloo ranks (1, 4) against the JAX
    package's single-device ``jax.jit(make_train_step)``, 2 AdamW steps
    (tolerances and AdamW's eps: tests/test_torch_sharded_ref.py), each
    config with heads that do not divide over 4 (6 / 3), so that every
    attention computes whole:

      * smollm-135m@inhibitor reduced (score scale 16, so that the
        inhibition terms are live at random init);
      * reduced hymba-1.5b with an 8-key window over 16 positions, beside
        the split Mamba branch that reads the same gathered norm output,
        and beside a Mamba branch computed whole (an odd width), whose
        whole gradient makes that gather's backward the rank's slice;
      * reduced seamless-m4t-large-v2: the encoder's non-causal
        self-attention over 12 frames, the decoder's causal self-attention
        over 16 tokens and its cross-attention over the memory, whose
        gradient each rank's query rows leave partial.

    Each case shows on every rank, in one forward: every attention's
    query rows (s/M) and key rows (s, or the memory's), the offset of its
    mask (rank · s/M), the RoPE positions of its queries (rank · s/M + i)
    and keys (0 … s − 1), no attention handed split, the region operators
    (no whole output sliced back to the rank's positions); and the
    gradients of ``wq``, ``wk``, ``wv``, ``wo`` (and the norms, the
    encoder's under the memory) whole, equal to the one-process gradient
    and the same on every rank.
(c) The sharded prefill (sequence-parallel over 8 prompt positions) and
    decode steps of the 6 / 3 head config on (1, 4) against the
    single-device steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dist_ranks as torch_dist_ranks
import test_torch_sharded_ref as ref
from repro.core import dotprod as jdot
from repro.core import inhibitor as jinh
from repro_torch.core import mechanism as tmech
from repro_torch.kernels import ops as kops

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
M = 4
#: structure -> (causal, window)
STRUCTURES = {"causal": (True, None), "window": (True, 6),
              "non-causal": (False, None)}


def _operands(seed, b, n, h, hk, d, qk_std):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, n, h, d)) * qk_std).astype(np.float32)
    k = (rng.normal(size=(b, n, hk, d)) * qk_std).astype(np.float32)
    v = rng.normal(size=(b, n, hk, d)).astype(np.float32)
    g = rng.normal(size=(b, n, h, d)).astype(np.float32)
    return q, k, v, g


def _jax_mask(n, causal, window):
    if window is not None:
        return jinh.sliding_window_mask(n, n, window)[None, None]
    return jinh.causal_mask(n, n)[None, None] if causal else None


@pytest.mark.parametrize("structure", list(STRUCTURES))
@pytest.mark.parametrize("mech", ["inhibitor", "dotprod"])
def test_kernel_entries_on_query_slices_equal_the_whole_call(mech,
                                                             structure):
    causal, window = STRUCTURES[structure]
    b, n, h, hk, d = 2, 32, 4, 2, 16
    inh = mech == "inhibitor"
    q, k, v, g = _operands(7, b, n, h, hk, d, d ** -0.5 if inh else 1.0)
    fn = kops.flash_inhibitor if inh else kops.flash_attention
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    gt = torch.from_numpy(g)

    def call(qq, offset):
        return fn(qq, leaves[1], leaves[2], causal=causal, window=window,
                  q_offset=offset)

    whole = call(leaves[0], 0)
    want = torch.autograd.grad(whole, leaves, gt)
    s = n // M
    kops.reset_counts()
    out = torch.cat([call(leaves[0][:, i * s:(i + 1) * s], i * s)
                     for i in range(M)], dim=1)
    name = "flash_inhibitor" if inh else "flash_attention"
    assert kops.counts()[name + "_plain"] == M
    # dq concatenated over the slices, dk and dv summed over them
    got = torch.autograd.grad(out, leaves, gt)
    np.testing.assert_allclose(out.detach().numpy(),
                               whole.detach().numpy(), **TOL)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), **GRAD_TOL)

    mask = _jax_mask(n, causal, window)

    def jfn(q, k, v):
        if inh:
            return jinh.inhibitor_attention(q, k, v, mask=mask)
        return jdot.dot_product_attention(q, k, v, mask=mask)

    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for a, r in zip(got, vjp(jnp.asarray(g))):
        assert np.abs(np.asarray(r)).max() > 1e-2
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL)

    # the control: every slice at offset 0 moves the causal structure
    if causal:
        bad = torch.cat([call(leaves[0][:, i * s:(i + 1) * s], 0)
                         for i in range(M)], dim=1).detach()
        assert (bad - whole.detach()).abs().max() > 1e3 * TOL["atol"]


@pytest.mark.parametrize("mech", ["inhibitor", "dotprod"])
def test_pallas_backend_sends_an_integer_offset_to_the_training_entry(
        mech, monkeypatch):
    """``Structural(q_offset=int)`` without cursors takes the
    differentiable entry at that offset; the cached entry is not
    reached."""
    from repro_torch.core.attention import AttentionConfig

    name = "flash_inhibitor" if mech == "inhibitor" else "flash_attention"

    def refused(*args, **kw):
        raise AssertionError("the cached entry was taken")

    monkeypatch.setattr(kops, name + "_cached", refused)
    cfg = AttentionConfig(mechanism=mech, backend="pallas", num_heads=4,
                          num_kv_heads=2, head_dim=16, sliding_window=6)
    shapes = tmech.AttnShapes(batch=2, n_q=8, n_k=32, num_heads=4,
                              num_kv_heads=2, head_dim=16, platform="cpu")
    plan = tmech.plan_attention(cfg, shapes)
    params = tmech.get_mechanism(mech).make_params(score_shift=0.5)
    q, k, v, _ = _operands(8, 2, 32, 4, 2, 16, 0.25)
    q = torch.from_numpy(q[:, 16:24]).requires_grad_()
    k, v = torch.from_numpy(k), torch.from_numpy(v)
    out = tmech.execute_plan(
        plan, q, k, v, params=params,
        structural=tmech.Structural(causal=True, window=6, q_offset=16))
    want = (kops.flash_inhibitor(q, k, v, None, 0.5, True, True, True, 6,
                                 q_offset=16) if mech == "inhibitor"
            else kops.flash_attention(q, k, v, None, True, 6, q_offset=16))
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__.startswith(
        "_FlashInhibitor" if mech == "inhibitor" else "_FlashAttention")


#: the first block's (or each stack's) attention weights and norms
def _attn_probes(*prefixes):
    out = {}
    for prefix in prefixes:
        tag = "/".join(map(str, prefix))
        for w in ("wq", "wk", "wv", "wo"):
            out[f"{tag}/{w}"] = (prefix + (w, "kernel"), None)
    return out


HEADS = dict(num_heads=6, num_kv_heads=3)
DENSE = dict(ref.DENSE, **HEADS)
LM_PROBES = dict(_attn_probes(("blocks", 0, "attn")),
                 ln1=(("blocks", 0, "ln1", "scale"), None))
ENCDEC_PROBES = dict(
    _attn_probes(("encoder", 1, "attn"), ("decoder", 0, "self_attn"),
                 ("decoder", 1, "cross_attn")),
    # (the key bias's gradient is 0 by analysis under Softmax)
    cross_bias=(("decoder", 1, "cross_attn", "wv", "bias"), None),
    enc_norm=(("enc_norm", "scale"), None),
    enc_ln1=(("encoder", 0, "ln1", "scale"), None))
#: (arch, overrides, other config fields, probes, (n_q, n_kv, causal,
#: RoPE) of each attention in call order, region operators of a forward)
CASES = {
    "smollm-inhibitor": (
        "smollm-135m@inhibitor", DENSE,
        {"attention": (("score_scale", 16.0),)}, LM_PROBES,
        [(4, 16, True, True)] * 2,
        dict(enter_summed=5, enter_own=0, exit=3, own=0, out_of_model=0)),
    "hymba-window": (
        "hymba-1.5b", HEADS, {"attention": (("sliding_window", 8),)},
        dict(LM_PROBES, branch_scale=(("blocks", 0, "branch_scale"), None),
             in_proj=(("blocks", 0, "mamba", "in_proj", "kernel"), None)),
        [(4, 16, True, True)] * 2,
        dict(enter_summed=5, enter_own=0, exit=5, own=0, out_of_model=2)),
    # an odd width leaves the Mamba branch whole (its 126 inner channels
    # do not divide over 4): the gathered norm output has a reader whose
    # gradient is whole, so the gather's backward is the rank's slice and
    # the attention sums its own K / V share over ``model``
    "hymba-mamba-whole": (
        "hymba-1.5b", dict(HEADS, d_model=63),
        {"attention": (("sliding_window", 8),)},
        dict(LM_PROBES, in_proj=(("blocks", 0, "mamba", "in_proj",
                                  "kernel"), None)),
        [(4, 16, True, True)] * 2,
        dict(enter_summed=3, enter_own=2, exit=3, own=2, out_of_model=0)),
    "seamless": (
        "seamless-m4t-large-v2", HEADS, None, ENCDEC_PROBES,
        [(3, 12, False, False)] * 2 + [(4, 16, True, False),
                                       (4, 12, None, False)] * 2,
        dict(enter_summed=9, enter_own=1, exit=5, own=1, out_of_model=0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_whole_attention_computes_its_query_rows(tmp_path, case):
    from repro_torch.configs import get_config

    arch, overrides, cfg_kw, probes, calls, regions = CASES[case]
    batch = ref.make_batch(get_config(arch).reduced(**overrides))
    params = ref.jax_params(arch, tuple(sorted(overrides.items())),
                            tuple(sorted((cfg_kw or {}).items())))
    ranks = torch_dist_ranks.run_ranks(
        M, "sp_attention",
        ((1, M), ("data", "model"), arch, overrides, params, batch, 2,
         ref.OPT, probes, cfg_kw), tmp_path)
    losses = ref.check_against_reference(ranks[0], arch, overrides, batch,
                                         steps=2, cfg_kw=cfg_kw)
    assert losses[1] < losses[0]
    for rank, r in enumerate(ranks):
        assert r["split_attn"] == [], r["split_attn"]
        assert {k: r["regions"][k] for k in regions} == regions, r["regions"]
        assert len(r["attention"]) == len(calls), r["attention"]
        for got, (n_q, n_kv, causal, rope) in zip(r["attention"], calls):
            assert got["q"][:2] == [ref.B, n_q], got
            assert got["k"][:2] == [ref.B, n_kv], got
            start = rank * n_q
            # a cross-attention builds no mask; a self-attention's offset
            # is its first query row, causal or not
            assert got["offset"] == (None if causal is None else start), got
            if rope:
                assert got["q_positions"] == list(range(start, start + n_q))
                assert got["k_positions"] == list(range(n_kv))
            else:
                assert got["q_positions"] is None, got
        for name, p in r["probes"].items():
            assert p["shape"] == p["full_shape"], (name, p["shape"])
            assert p["err"] <= 1e-5, (name, p["err"])
    for name in probes:
        grads = [r["probes"][name]["grad"] for r in ranks]
        scale = np.abs(grads[0]).max()
        assert scale > 0, name
        for g in grads[1:]:
            assert np.abs(g - grads[0]).max() <= 1e-6 * scale, name


def test_sharded_prefill_and_decode_with_a_query_split(tmp_path):
    from repro_torch.configs import get_config

    rng = np.random.default_rng(6)
    arch = "smollm-135m"
    v = get_config(arch).reduced(**DENSE).vocab_size
    cases = [((1, M), arch, DENSE,
              ref.jax_params(arch, tuple(sorted(DENSE.items()))),
              rng.integers(0, v, (4, 8)).astype(np.int32),
              rng.integers(0, v, (2, 4, 1)).astype(np.int32))]
    for r in torch_dist_ranks.run_ranks(M, "tp_serving", (cases,),
                                        tmp_path):
        got = r[0]
        want, have = got["prefill"]
        np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-5)
        for ref_logits, logits, ref_next, nxt in got["steps"]:
            np.testing.assert_allclose(logits, ref_logits, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_array_equal(nxt, ref_next)
