"""The port's attention backward passes against ``jax.grad`` of the JAX
package on the same numpy inputs.

* The analytic inhibitor VJP (``core.inhibitor.inhibitor_attention_vjp``,
  the backward of ``inhibitor_attention`` and of the training kernel),
  walking the keys in chunks of 1, 7 and all of them, against ``jax.vjp``
  of ``repro.core.inhibitor.inhibitor_attention`` (whose custom VJP it
  ports): signed / unsigned, shift 0 / 0.5 (the gate 1[raw > α]),
  normalized or not, a causal mask, a random mask applied by exclusion,
  no mask, GQA.  Then the same through ``torch.autograd`` on
  ``inhibitor_attention``.
* The lean Softmax backward of ``core.dotprod`` against ``jax.vjp`` of
  ``repro.core.dotprod.dot_product_attention``.

Inputs are live (q, k of stddev 1/sqrt(d): Z about 0.6), and every
gradient is asserted nonzero.  Tolerance rtol 1e-4, atol 1e-5, as
``tests/test_kernels.py::test_ops_grads_match_ref``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dotprod as jdp
from repro.core import inhibitor as jinh
from repro_torch.core import dotprod as tdp
from repro_torch.core import inhibitor as tinh

TOL = dict(rtol=1e-4, atol=1e-5)
B, N, H, HK, D = 2, 13, 4, 2, 8


def _inputs(seed, qk_std):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, N, H, D)) * qk_std).astype(np.float32)
    k = (rng.normal(size=(B, N, HK, D)) * qk_std).astype(np.float32)
    v = rng.normal(size=(B, N, HK, D)).astype(np.float32)
    g = rng.normal(size=(B, N, H, D)).astype(np.float32)
    return q, k, v, g


def _mask(kind):
    if kind == "none":
        return None
    if kind == "causal":
        return np.tril(np.ones((N, N), bool))[None, None]
    m = np.random.default_rng(9).random((B, 1, N, N)) > 0.4
    m[..., 0] = True
    return m


@functools.lru_cache(maxsize=None)
def _jax_inhibitor_grads(signed, shift, normalize, mask_kind):
    q, k, v, g = _inputs(0, D ** -0.5)
    m = _mask(mask_kind)

    def f(q_, k_, v_):
        return jinh.inhibitor_attention(
            q_, k_, v_, mask=None if m is None else jnp.asarray(m),
            signed=signed, score_shift=shift, normalize=normalize)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return tuple(np.asarray(x) for x in vjp(jnp.asarray(g)))


def _check(got, ref):
    for a, r in zip(got, ref):
        assert np.abs(r).max() > 1e-3          # live gradients
        np.testing.assert_allclose(a.detach().numpy(), r, **TOL)


@pytest.mark.parametrize("mask_kind", ["causal", "random", "none"])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("shift", [0.0, 0.5])
@pytest.mark.parametrize("signed", [True, False])
def test_inhibitor_vjp_chunks_match_jax(signed, shift, normalize, mask_kind):
    ref = _jax_inhibitor_grads(signed, shift, normalize, mask_kind)
    q, k, v, g = map(torch.from_numpy, _inputs(0, D ** -0.5))
    m = _mask(mask_kind)
    mask = None if m is None else torch.from_numpy(m)
    for chunk in (1, 7, N):
        got = tinh.inhibitor_attention_vjp(
            q, k, v, g, mask=mask, signed=signed, score_shift=shift,
            normalize=normalize, kv_chunk=chunk)
        _check(got, ref)


@pytest.mark.parametrize("mask_kind", ["causal", "random"])
@pytest.mark.parametrize("signed", [True, False])
def test_inhibitor_autograd_matches_jax(signed, mask_kind):
    """``inhibitor_attention`` under torch.autograd takes the analytic
    backward (the default chunk) and agrees with jax.grad."""
    ref = _jax_inhibitor_grads(signed, 0.5, True, mask_kind)
    q, k, v, g = map(torch.from_numpy, _inputs(0, D ** -0.5))
    m = _mask(mask_kind)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    out = tinh.inhibitor_attention(*leaves, mask=torch.from_numpy(m),
                                   signed=signed, score_shift=0.5)
    _check(torch.autograd.grad(out, leaves, g), ref)


def test_inhibitor_chunk_rows_skip_unattended_queries():
    """Under a causal mask a key chunk [lo, hi) visits only rows i >= lo;
    a chunk no query attends is skipped."""
    m = torch.from_numpy(np.tril(np.ones((6, 6), bool))[None, None])
    assert tinh._chunk_rows(m, 6, 6, 4) == [(0, 4, 0, 6), (4, 6, 4, 6)]
    m[..., 4:] = False
    assert tinh._chunk_rows(m, 6, 6, 4)[1] == (4, 6, 0, 0)
    assert tinh._chunk_rows(None, 3, 6, 4) == [(0, 4, 0, 3), (4, 6, 0, 3)]


@pytest.mark.parametrize("mask_kind", ["causal", "random", "none"])
def test_dotprod_backward_matches_jax(mask_kind):
    q, k, v, g = _inputs(1, 1.0)
    m = _mask(mask_kind)

    def f(q_, k_, v_):
        return jdp.dot_product_attention(
            q_, k_, v_, mask=None if m is None else jnp.asarray(m))

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    ref = tuple(np.asarray(x) for x in vjp(jnp.asarray(g)))
    tmask = None if m is None else torch.from_numpy(m)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    _check(tdp.dot_product_attention_vjp(tq, tk, tv, tg, mask=tmask), ref)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = tdp.dot_product_attention(*leaves, mask=tmask)
    _check(torch.autograd.grad(out, leaves, tg), ref)


def test_dotprod_saves_only_compute_dtype_probabilities():
    """The lean core's residuals: q, k, v and the probabilities in the
    compute dtype (bf16 here), not float32 score-sized tensors."""
    q, k, v, _ = (torch.from_numpy(x).bfloat16() for x in _inputs(2, 1.0))
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    leaves = [x.requires_grad_() for x in (q, k, v)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tdp.dot_product_attention(*leaves)
    scores = [s for s in saved if s[0] == (B, H, N, N)]
    assert scores == [((B, H, N, N), torch.bfloat16)]
