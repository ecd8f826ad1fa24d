"""The port's Mamba block (the selective SSM half of repro_torch.nn.ssm)
against the JAX package's (repro.nn.ssm) on the same numpy inputs and
parameters.

* ``_causal_depthwise_conv``: outputs and the new carry, from a zero
  carry and from a drawn one.
* ``selective_scan_ref``: outputs and the final state, from a zero state
  and from a drawn one.
* ``apply_mamba``: outputs and both carries from zero state; prefill of 7
  tokens, then two decode steps of one token from the returned carries,
  equal to the whole 9-token forward (the port against itself, at 1e-5),
  and every carry equal to the reference's after the same calls.
* ``init_mamba``: the reference's shapes and dtypes (float32 ``A_log``
  and ``D``), the S4D-real ``A_log`` = log [1..n] on every channel,
  ``D`` = 1.
* Gradients of ``apply_mamba`` with respect to the input and every
  parameter equal ``jax.grad``'s (1e-4 of their norm).

The reference leaves ``conv_b`` and the ``dt_proj`` bias zero at init;
the test draws them from a numpy seed, so those terms are live.
Tolerance: float32 on both sides, rtol 1e-5, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import ssm as jssm
from repro.nn.module import unbox
from repro_torch.nn import ssm as tssm

TOL = dict(rtol=1e-5, atol=1e-5)
D_MODEL, INNER, N, K = 16, 32, 8, 4


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _params(seed=0):
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, unbox(jssm.init_mamba(
        jax.random.PRNGKey(seed), D_MODEL, INNER, state_dim=N, conv_dim=K)))
    p["conv_b"] = rng.normal(size=p["conv_b"].shape).astype(np.float32)
    p["dt_proj"] = dict(p["dt_proj"], bias=(0.5 * rng.normal(
        size=p["dt_proj"]["bias"].shape) - 1.0).astype(np.float32))
    return p


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


@pytest.mark.parametrize("with_carry", [False, True])
def test_causal_depthwise_conv_matches_reference(with_carry):
    x, w, b = _rand(1, 2, 6, INNER), _rand(2, K, INNER), _rand(3, INNER)
    carry = _rand(4, 2, K - 1, INNER) if with_carry else None
    jy, jc = jssm._causal_depthwise_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if carry is None else jnp.asarray(carry))
    ty, tc = tssm._causal_depthwise_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if carry is None else torch.from_numpy(carry))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_selective_scan_matches_reference(with_state):
    b, t = 2, 7
    u = _rand(1, b, t, INNER)
    dt = np.log1p(np.exp(_rand(2, b, t, INNER)))
    A = np.log(np.tile(np.arange(1, N + 1, dtype=np.float32), (INNER, 1)))
    B, C, Dp = _rand(3, b, t, N), _rand(4, b, t, N), _rand(5, INNER)
    state = _rand(6, b, INNER, N) if with_state else None
    args = (u, dt, A, B, C, Dp)
    jy, js = jssm.selective_scan_ref(
        *map(jnp.asarray, args),
        None if state is None else jnp.asarray(state))
    ty, ts = tssm.selective_scan_ref(
        *map(torch.from_numpy, args),
        None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_apply_mamba_prefill_then_decode_matches_reference_and_forward():
    p = _params()
    jp, tp = jax.tree.map(jnp.asarray, p), _to_torch(p)
    x = _rand(7, 2, 9, D_MODEL)
    whole, (ws, wc) = tssm.apply_mamba(tp, torch.from_numpy(x), state_dim=N)
    jwhole, (jws, jwc) = jssm.apply_mamba(jp, jnp.asarray(x), state_dim=N)
    np.testing.assert_allclose(whole.numpy(), np.asarray(jwhole), **TOL)
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), **TOL)
    np.testing.assert_allclose(wc.numpy(), np.asarray(jwc), **TOL)
    jst = tst = (None, None)
    outs = []
    for lo, hi in ((0, 7), (7, 8), (8, 9)):
        ty, tst = tssm.apply_mamba(tp, torch.from_numpy(x[:, lo:hi]),
                                   state_dim=N, ssm_state=tst[0],
                                   conv_state=tst[1])
        jy, jst = jssm.apply_mamba(jp, jnp.asarray(x[:, lo:hi]),
                                   state_dim=N, ssm_state=jst[0],
                                   conv_state=jst[1])
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for t, j in zip(tst, jst):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
        outs.append(ty)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(),
                               **TOL)
    np.testing.assert_allclose(tst[0].numpy(), ws.numpy(), **TOL)
    np.testing.assert_allclose(tst[1].numpy(), wc.numpy(), **TOL)
    assert tst[0].dtype == torch.float32
    assert tuple(tst[1].shape) == (2, K - 1, INNER)


def test_init_mamba_matches_reference_layout():
    ref = _params()
    got = tssm.init_mamba(torch.Generator().manual_seed(0), D_MODEL, INNER,
                          state_dim=N, conv_dim=K)
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), ref)
            == jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).replace("torch.", "")),
                            got))
    # log [1..n] on every channel, to the last float32 ulp of the log
    np.testing.assert_allclose(got["A_log"].numpy(), ref["A_log"],
                               rtol=2 ** -23, atol=0)
    assert bool((got["A_log"] == got["A_log"][:1]).all())
    assert bool((got["D"] == 1).all())
    assert got["dt_proj"]["kernel"].shape == (max(1, D_MODEL // 16), INNER)


def test_apply_mamba_gradients_match_reference():
    p = _params(1)
    x = _rand(8, 2, 5, D_MODEL)
    w = _rand(9, 2, 5, D_MODEL)

    def jloss(params, xx):
        y, (s, c) = jssm.apply_mamba(params, xx, state_dim=N)
        return jnp.sum(y * w) + jnp.sum(s) + jnp.sum(c)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = jax.tree.map(lambda a: a.requires_grad_(True), _to_torch(p))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, (s, c) = tssm.apply_mamba(tp, tx, state_dim=N)
    loss = (y * torch.from_numpy(w)).sum() + s.sum() + c.sum()
    leaves = jax.tree.leaves(tp)
    grads = torch.autograd.grad(loss, [tx] + leaves, allow_unused=True)
    pairs = [(grads[0], jg_x)] + list(zip(grads[1:], jax.tree.leaves(jg_p)))
    assert len(pairs) == len(leaves) + 1
    for g, jg in pairs:
        jg = np.asarray(jg)
        g = np.zeros_like(jg) if g is None else g.numpy()
        err = np.linalg.norm(g - jg)
        assert err <= 1e-4 * max(np.linalg.norm(jg), 1e-6), (err, jg.shape)
