"""The port's ``blocked`` inhibitor backend (repro_torch.core.blocked)
against the JAX package's (repro.core.blocked) on the same numpy inputs:
outputs and q / k / v gradients, signed and unsigned, under a causal
mask with and without a window, a scalar query offset with a valid
length, and without structure; the planner's choice of ``blocked`` at
n_q * n_k >= 2^20 on the CPU; and the 1024-token forward of a reduced
smollm-135m@inhibitor, whose attention the planner sends there, against
the reference's logits on converted parameters.

Tolerance: float32 on both sides, summation order only: rtol = atol =
1e-5 (outputs and gradients; the unnormalized sums reach ~25, where the
relative term dominates).  Chunk sizes that divide neither length (16 x
8 at n 37 / 45) make the chunk loops, the skipped chunk pairs and the
ragged last chunks all count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.blocked import blocked_inhibitor_attention as jax_blocked
from repro.models.registry import get_model as jax_model
from repro.nn.module import unbox
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import mechanism as tmech
from repro_torch.core.attention import AttentionConfig
from repro_torch.core.blocked import blocked_inhibitor_attention
from repro_torch.models.registry import get_model

TOL = dict(rtol=1e-5, atol=1e-5)

# (mask kwargs, n_q, n_k)
MASK_CASES = {
    "causal": (dict(causal=True), 37, 37),
    "causal_window": (dict(causal=True, window=9), 37, 37),
    "offset_valid_len": (dict(causal=True, q_offset=8, kv_valid_len=40),
                         37, 45),
    "unstructured_unnormalized": (dict(causal=False, normalize=False), 37,
                                  45),
}


def _operands(seed, n_q, n_k, b=2, h=4, hk=2, d=16):
    """q, k of stddev 1/sqrt(d) (scores near 0.6: the inhibition is
    materially nonzero), v unit normal, and an output cotangent."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(b, n_q, h, d)) * d ** -0.5).astype(np.float32)
    k = (rng.normal(size=(b, n_k, hk, d)) * d ** -0.5).astype(np.float32)
    v = rng.normal(size=(b, n_k, hk, d)).astype(np.float32)
    g = rng.normal(size=(b, n_q, h, d)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_blocked_matches_reference_with_grads(signed, case):
    mask_kw, n_q, n_k = MASK_CASES[case]
    kw = dict(mask_kw, signed=signed, chunk_q=16, chunk_k=8)
    q, k, v, g = _operands(0, n_q, n_k)
    ref, vjp = jax.vjp(lambda *x: jax_blocked(*x, **kw),
                       *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = blocked_inhibitor_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert np.abs(np.asarray(ref)).max() > 0.05
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    for got, want in zip(grads, ref_grads):
        assert np.abs(np.asarray(want)).max() > 0.05
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_blocked_refuses_per_row_cursors():
    q, k, v, _ = _operands(1, 8, 8)
    with pytest.raises(ValueError, match="one value"):
        blocked_inhibitor_attention(
            *map(torch.from_numpy, (q, k, v)),
            kv_valid_len=torch.tensor([8, 6]))


@pytest.mark.parametrize("mech", ["inhibitor", "inhibitor_unsigned"])
def test_plan_large_structural_goes_blocked(mech):
    """At n_q * n_k >= 2^20 on the CPU (no native kernel) the planner
    picks ``blocked`` for both inhibitor mechanisms, just below it not;
    the plan runs and equals the dense fused backend."""
    cfg = AttentionConfig(mechanism=mech, num_heads=4, num_kv_heads=2,
                          head_dim=16)
    shapes = tmech.AttnShapes(batch=1, n_q=1024, n_k=1024, num_heads=4,
                              num_kv_heads=2, head_dim=16, platform="cpu")
    plan = tmech.plan_attention(cfg, shapes)
    assert plan.backend == "blocked"
    assert "blocked_threshold" in plan.reason
    assert tmech.plan_attention(
        cfg, shapes._replace(n_q=1023)).backend != "blocked"
    q, k, v, _ = (torch.from_numpy(x) for x in _operands(2, 40, 40))
    params = tmech.get_mechanism(mech).make_params(score_shift=0.5,
                                                   kv_chunk=16)
    out = tmech.execute_plan(plan, q, k, v, params=params,
                             structural=tmech.Structural(causal=True))
    mask = torch.ones(40, 40, dtype=torch.bool).tril()[None, None]
    fused = tmech.execute_plan(
        tmech.ExecutionPlan(mech, "fused", "t"), q, k, v, params=params,
        mask=mask)
    torch.testing.assert_close(out, fused, **TOL)


def test_reduced_inhibitor_lm_forward_on_1024_tokens_matches_reference():
    """smollm-135m@inhibitor reduced to 1 layer (d 32, d_ff 64, vocab
    128), batch 1, 1024 tokens: n_q * n_k = 2^20 sends its attention to
    ``blocked`` on both sides; wq and wk scaled by 1/sqrt(head_dim) in
    both trees so that the inhibition reaches the logits."""
    small = dict(num_layers=1, d_model=32, d_ff=64, vocab_size=128,
                 max_seq_len=1024)
    jcfg = jax_config("smollm-135m@inhibitor").reduced(**small)
    tcfg = get_config("smollm-135m@inhibitor").reduced(**small)
    a = tcfg.attention
    assert tmech.plan_attention(a, tmech.AttnShapes(
        batch=1, n_q=1024, n_k=1024, num_heads=a.num_heads,
        num_kv_heads=a.num_kv_heads, head_dim=a.head_dim,
        platform="cpu")).backend == "blocked"
    japi = jax_model(jcfg)
    jp = unbox(jax.jit(japi.init)(jax.random.PRNGKey(0)))
    attn = dict(jp["blocks"]["attn"])
    for w in ("wq", "wk"):
        attn[w] = dict(attn[w], kernel=attn[w]["kernel"] * a.head_dim ** -0.5)
    jp = dict(jp, blocks=dict(jp["blocks"], attn=attn))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks = np.random.default_rng(3).integers(0, 128, (1, 1024)).astype(
        np.int32)
    ref, _ = jax.jit(japi.forward)(jp, {"tokens": jnp.asarray(toks)})
    got = get_model(tcfg).forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=5e-5)
    # the attention is live: without it (V zeroed) the logits move
    tp0 = dict(tp, blocks=[dict(b, attn=dict(b["attn"], wv=dict(
        b["attn"]["wv"], kernel=torch.zeros_like(
            b["attn"]["wv"]["kernel"])))) for b in tp["blocks"]])
    moved = get_model(tcfg).forward(tp0, {"tokens": torch.from_numpy(toks)})
    assert (moved - got).abs().max().item() > 1e-3
