"""The port's attention math and planner (repro_torch.core) against the JAX
package on the same numpy inputs: eq. 5 scores, the eq. 6/7 naive and
eq. 9/10 fused forms, the multi-head entry points (full and chunked),
dot-product attention, the window-implies-causal semantics of
tests/test_window_semantics.py (forward), and ``plan_attention`` parity
for the serving slice's call sites.

Tolerance: float32 on both sides, summation order only — rtol = atol =
1e-5 (1e-4 absolute on the window cases, whose layer outputs go through
two projections as in the reference test).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as jatt
from repro.core import dotprod as jdp
from repro.core import inhibitor as jinh
from repro.core import mechanism as jmech
from repro.nn.module import unbox
from repro_torch.core import attention as tatt
from repro_torch.core import dotprod as tdp
from repro_torch.core import inhibitor as tinh
from repro_torch.core import mechanism as tmech

# full float32 matmuls and convolutions on a card (TF32 keeps ~3 digits)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(rng, *shape):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("shift", [0.0, 0.5, 2.0])
def test_scores_and_naive_and_fused_forms(rng, signed, shift):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, 2, 3, 6, 8),
                                    _pair(rng, 2, 3, 10, 8),
                                    _pair(rng, 2, 3, 10, 8))
    jz = jinh.manhattan_scores(jq, jk, score_shift=shift)
    tz = tinh.manhattan_scores(tq, tk, score_shift=shift)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    naive = ((jinh.inhibit_signed_naive, tinh.inhibit_signed_naive) if signed
             else (jinh.inhibit_naive, tinh.inhibit_naive))
    fused = ((jinh.inhibit_signed_fused, tinh.inhibit_signed_fused) if signed
             else (jinh.inhibit_fused, tinh.inhibit_fused))
    for jf, tf in (naive, fused):
        np.testing.assert_allclose(tf(tv, tz).numpy(),
                                   np.asarray(jf(jv, jz)), **TOL)
    # eq. 9/10 ≡ eq. 6/7 inside the port itself
    np.testing.assert_allclose(fused[1](tv, tz).numpy(),
                               naive[1](tv, tz).numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("signed", [True, False])
def test_masked_fused_equals_reference_and_masked_naive(rng, signed):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, 2, 2, 5, 4),
                                    _pair(rng, 2, 2, 7, 4),
                                    _pair(rng, 2, 2, 7, 4))
    m = np.random.default_rng(1).random((2, 2, 5, 7)) > 0.4
    jm, tm = jnp.asarray(m), torch.from_numpy(m)
    jz = jinh.manhattan_scores(jq, jk, score_shift=0.5)
    tz = tinh.manhattan_scores(tq, tk, score_shift=0.5)
    jf = jinh.inhibit_signed_fused if signed else jinh.inhibit_fused
    tf = tinh.inhibit_signed_fused if signed else tinh.inhibit_fused
    tn = tinh.inhibit_signed_naive if signed else tinh.inhibit_naive
    out = tf(tv, tz, tm).numpy()
    np.testing.assert_allclose(out, np.asarray(jf(jv, jz, jm)), **TOL)
    np.testing.assert_allclose(out, tn(tv, tinh.mask_scores(tz, tm)).numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("kv_chunk", [5, 16])
def test_inhibitor_attention_full_and_chunked(rng, signed, kv_chunk):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, 2, 16, 4, 8),
                                    _pair(rng, 2, 16, 2, 8),
                                    _pair(rng, 2, 16, 2, 8))
    jm = jinh.causal_mask(16, 16)[None, None]
    tm = tinh.causal_mask(16, 16)[None, None]
    ref = np.asarray(jinh.inhibitor_attention(jq, jk, jv, mask=jm,
                                              signed=signed))
    full = tinh.inhibitor_attention(tq, tk, tv, mask=tm, signed=signed)
    chunked = tinh.inhibitor_attention_chunked(tq, tk, tv, mask=tm,
                                               signed=signed,
                                               kv_chunk=kv_chunk)
    np.testing.assert_allclose(full.numpy(), ref, **TOL)
    np.testing.assert_allclose(chunked.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_dot_product_attention_and_masked_positions(rng):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, 2, 6, 4, 8),
                                    _pair(rng, 2, 9, 2, 8),
                                    _pair(rng, 2, 9, 2, 8))
    m = np.random.default_rng(2).random((2, 1, 6, 9)) > 0.3
    m[..., 0] = True
    ref = jdp.dot_product_attention(jq, jk, jv, mask=jnp.asarray(m))
    out = tdp.dot_product_attention(tq, tk, tv, mask=torch.from_numpy(m))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # masked-out keys never change the inhibitor's output
    big_k = torch.cat([tk, 100 * torch.randn(2, 3, 2, 8)], dim=1)
    big_v = torch.cat([tv, 100 * torch.randn(2, 3, 2, 8)], dim=1)
    mask = torch.cat([torch.ones(1, 1, 6, 9, dtype=torch.bool),
                      torch.zeros(1, 1, 6, 3, dtype=torch.bool)], -1)
    np.testing.assert_allclose(
        tinh.inhibitor_attention(tq, big_k, big_v, mask=mask).numpy(),
        tinh.inhibitor_attention(tq, tk, tv).numpy(), rtol=1e-4, atol=1e-4)


WINDOW = 8


def _attn_cfgs(mech, backend=None, causal=True):
    kw = dict(mechanism=mech, backend=backend, num_heads=4, num_kv_heads=2,
              head_dim=8, causal=causal, sliding_window=WINDOW)
    return jatt.AttentionConfig(**kw), tatt.AttentionConfig(**kw)


@functools.lru_cache(maxsize=None)
def _window_case(mech):
    """(reference params, port params, input x, the reference's causal
    naive output) — the JAX oracle runs once per mechanism."""
    jcfg, _ = _attn_cfgs(mech, backend="naive", causal=True)
    jp = unbox(jatt.init_attention(jax.random.PRNGKey(0), jcfg, 32))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(7).normal(size=(2, 32, 32)).astype(np.float32)
    y_ref = jax.jit(lambda p, x_: jatt.apply_attention(p, jcfg, x_)[0])(
        jp, jnp.asarray(x))
    return jp, tp, x, np.asarray(y_ref)


@pytest.mark.parametrize("mech", ["inhibitor", "inhibitor_unsigned",
                                  "dotprod"])
@pytest.mark.parametrize("backend", ["naive", "fused", "chunked"])
@pytest.mark.parametrize("causal", [True, False])
def test_window_implies_causal_matches_reference(rng, mech, backend, causal):
    """Every (backend, causal flag) under a sliding window equals the
    reference's causal naive oracle."""
    _, tcfg = _attn_cfgs(mech, backend=backend, causal=causal)
    shapes = tmech.AttnShapes(batch=2, n_q=32, n_k=32, num_heads=4,
                              num_kv_heads=2, head_dim=8, platform="cpu")
    ok, why = tmech.backend_eligible(backend, tcfg, shapes,
                                     tmech.get_mechanism(mech))
    if not ok:
        pytest.skip(f"{backend}: {why}")
    _, tp, x, y_ref = _window_case(mech)
    y, _ = tatt.apply_attention(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mech", ["inhibitor", "dotprod"])
def test_window_semantics_survive_decode_cache(rng, mech):
    """Prefill 11 + decode 1 through the port's cache equals the
    reference's causal full-sequence oracle at the decoded position."""
    _, tp, x, y_full = _window_case(mech)
    _, tcfg = _attn_cfgs(mech, causal=False)
    cache = tatt.init_kv_cache(1, 16, 2, 8, torch.float32, device="cpu")
    xt = torch.from_numpy(x[:1, :12])
    _, cache = tatt.apply_attention(tp, tcfg, xt[:, :11], cache=cache)
    y_dec, _ = tatt.apply_attention(tp, tcfg, xt[:, 11:12], cache=cache)
    np.testing.assert_allclose(y_dec[:, 0].numpy(), y_full[:1, 11],
                               rtol=1e-4, atol=1e-4)


# (cfg overrides, AttnShapes kwargs): the slice's call sites plus the
# planner's other branches
_PLAN_CASES = {
    "paged_decode": ({}, dict(batch=8, n_q=1, n_k=512, has_cache=True,
                              scalar_cursor=False, paged=True)),
    "paged_prefill_chunk": ({}, dict(batch=1, n_q=32, n_k=512,
                                     has_cache=True, scalar_cursor=False,
                                     paged=True)),
    "contiguous_prefill": ({}, dict(batch=2, n_q=128, n_k=128)),
    "per_slot_decode": ({}, dict(batch=8, n_q=1, n_k=512, has_cache=True,
                                 scalar_cursor=False)),
    "long_blocked": ({}, dict(batch=1, n_q=2048, n_k=2048)),
    "long_chunked": ({}, dict(batch=1, n_q=1, n_k=8192, has_cache=True)),
    "explicit_mask": ({}, dict(batch=1, n_q=2048, n_k=2048,
                               has_explicit_mask=True)),
    "forced_naive": (dict(backend="naive"), dict(batch=1, n_q=4, n_k=4)),
    "use_kernel_shim": (dict(use_kernel=True), dict(batch=1, n_q=8, n_k=8)),
}


@pytest.mark.parametrize("mech", ["inhibitor", "dotprod"])
@pytest.mark.parametrize("case", sorted(_PLAN_CASES))
def test_plan_attention_matches_reference(mech, case):
    over, shape_kw = _PLAN_CASES[case]
    kw = dict(mechanism=mech, num_heads=9, num_kv_heads=3, head_dim=64,
              **over)
    heads = dict(num_heads=9, num_kv_heads=3, head_dim=64, platform="cpu")
    ref = jmech.plan_attention(jatt.AttentionConfig(**kw),
                               jmech.AttnShapes(**shape_kw, **heads))
    got = tmech.plan_attention(tatt.AttentionConfig(**kw),
                               tmech.AttnShapes(**shape_kw, **heads))
    assert got == tmech.ExecutionPlan(ref.mechanism, ref.backend, ref.reason)


def test_cuda_decode_plans_the_kernel_and_unported_backends_raise():
    """On CUDA the planner picks the paged decode kernel for a paged
    single-query decode and the blockwise flash kernels (``pallas``) for a
    training forward at n_q * n_k >= 2^20, for both families; ``blocked``
    runs (tests/test_torch_blocked.py holds it against the reference);
    ``int`` and ``fhe_sim``, which raised until the lanes were ported, run
    on integer inputs and return int32 (tests/test_torch_quant_fhe.py
    holds them against the reference)."""
    cfg = tatt.AttentionConfig(mechanism="inhibitor", num_heads=9,
                               num_kv_heads=3, head_dim=64)
    decode = tmech.AttnShapes(batch=8, n_q=1, n_k=512, num_heads=9,
                              num_kv_heads=3, head_dim=64, has_cache=True,
                              scalar_cursor=False, platform="cuda",
                              paged=True)
    assert tmech.plan_attention(cfg, decode).backend == "paged_pallas"
    assert tmech.plan_attention(
        cfg, decode._replace(n_q=32)).backend == "paged"
    train = tmech.AttnShapes(batch=8, n_q=1024, n_k=1024, num_heads=9,
                             num_kv_heads=3, head_dim=64, platform="cuda")
    for mech in ("inhibitor", "inhibitor_unsigned", "dotprod"):
        mcfg = tatt.AttentionConfig(mechanism=mech, num_heads=9,
                                    num_kv_heads=3, head_dim=64)
        assert tmech.plan_attention(mcfg, train).backend == "pallas"
        assert tmech.plan_attention(
            mcfg, train._replace(n_q=1023)).backend != "pallas"
        assert tmech.plan_attention(
            mcfg, train._replace(platform="cpu")).backend != "pallas"
    q = torch.zeros(1, 4, 9, 64)
    params = tmech.get_mechanism("inhibitor").make_params()
    out = tmech.execute_plan(
        tmech.ExecutionPlan("inhibitor", "blocked", "t"), q, q[:, :, :3],
        q[:, :, :3], params=params, structural=tmech.Structural())
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    qi = torch.arange(4 * 9 * 64, dtype=torch.int32).reshape(1, 4, 9, 64)
    for backend in ("int", "fhe_sim"):
        out = tmech.execute_plan(
            tmech.ExecutionPlan("inhibitor", backend, "t"), qi % 17,
            qi[:, :, :3] % 13, qi[:, :, :3] % 11, params=params)
        assert out.shape == q.shape and out.dtype == torch.int32
