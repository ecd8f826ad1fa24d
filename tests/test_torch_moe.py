"""The port's Mixture-of-Experts layer (repro_torch.nn.moe) against the JAX
package's (repro.nn.moe) on the same numpy inputs and parameters.

* ``apply_moe`` outputs and every ``MoEAux`` field (load-balance loss,
  router-z loss, dropped fraction) equal the reference's, over: the
  default capacity factor 1.25 (no drop at 16 tokens, 4 experts, top 2);
  a capacity factor of 0.25 that drops (the capacity is then 2 rows an
  expert, and the dropped fraction must be equal and above 0); the shared
  expert without and with its sigmoid gate; ``normalize_topk`` both
  ways; and top 1 (which drops too, at 5 rows an expert).
* Gradients of one scalar of the output and the aux losses with respect
  to the input and every parameter equal ``jax.grad``'s.
* The capacity rule ``int(max(k, cf·k·T/E))`` capped at T.
* Padded experts: a qwen2-moe reduced config with ``num_experts`` 6
  padded to 8.  Both packages build 8-expert stacks, the router draws all
  8 columns alike (the reference's ``init_moe``), a padding expert is
  routed to like any other, and the model's logits agree.

Tolerance: float32 on both sides; the outputs and aux to rtol 1e-5,
atol 1e-5 (the combine sums a token's k contributions in another order
than XLA's scatter-add), the gradients to 1e-4 of their norm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.nn import moe as jmoe
from repro.nn.module import unbox
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.nn import moe as tmoe

TOL = dict(rtol=1e-5, atol=1e-5)
D, F, E = 16, 24, 4


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _params(seed, *, shared=0, gate=False, experts=E):
    """The reference's MoE parameters (no bias, nothing zero at init), as
    numpy."""
    p = unbox(jmoe.init_moe(jax.random.PRNGKey(seed), D, F, experts,
                            shared_hidden_dim=shared, shared_gate=gate))
    return jax.tree.map(np.asarray, p)


def _x(seed, b=2, s=8):
    return np.random.default_rng(seed).normal(size=(b, s, D)).astype(
        np.float32)


CASES = {
    "default": dict(),
    "drops": dict(capacity_factor=0.25),
    "shared": dict(shared=32),
    "shared_gate": dict(shared=32, gate=True),
    "unnormalized": dict(normalize_topk=False),
    "top1": dict(top_k=1, shared=32, gate=True),
}


def _run_both(case):
    kw = dict(CASES[case])
    shared, gate = kw.pop("shared", 0), kw.pop("gate", False)
    kw.setdefault("top_k", 2)
    p = _params(1, shared=shared, gate=gate)
    x = _x(2)
    jy, jaux = jmoe.apply_moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              compute_dtype=jnp.float32, **kw)
    ty, taux = tmoe.apply_moe(_to_torch(p), torch.from_numpy(x),
                              compute_dtype=torch.float32, **kw)
    return p, x, kw, (jy, jaux), (ty, taux)


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_moe_and_aux_match_reference(case):
    _, _, _, (jy, jaux), (ty, taux) = _run_both(case)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in tmoe.MoEAux._fields:
        np.testing.assert_allclose(getattr(taux, name).numpy(),
                                   np.asarray(getattr(jaux, name)), **TOL,
                                   err_msg=name)
    dropped = float(taux.dropped_fraction)
    assert dropped == float(jaux.dropped_fraction)
    if case == "drops":
        assert dropped > 0
    elif case == "default":
        assert dropped == 0.0


@pytest.mark.parametrize("case", ["default", "drops", "shared_gate"])
def test_apply_moe_gradients_match_reference(case):
    """d/d(x, params) of sum(y · w) + lb + z, both packages."""
    p, x, kw, _, _ = _run_both(case)
    w = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jloss(params, xx):
        y, aux = jmoe.apply_moe(params, xx, compute_dtype=jnp.float32, **kw)
        return (jnp.sum(y * w) + aux.load_balance_loss + aux.router_z_loss)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = jax.tree.map(lambda a: a.requires_grad_(True), _to_torch(p))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.apply_moe(tp, tx, compute_dtype=torch.float32, **kw)
    loss = (y * torch.from_numpy(w)).sum() + aux.load_balance_loss \
        + aux.router_z_loss
    leaves = jax.tree.leaves(tp)
    grads = torch.autograd.grad(loss, [tx] + leaves)
    pairs = [(grads[0], jg_x)] + list(zip(grads[1:], jax.tree.leaves(jg_p)))
    assert len(pairs) == len(leaves) + 1
    for g, jg in pairs:
        jg = np.asarray(jg)
        err = np.linalg.norm(g.numpy() - jg)
        assert err <= 1e-4 * max(np.linalg.norm(jg), 1e-6), (err, jg.shape)


@pytest.mark.parametrize("k,cf,t,e,want", [
    (2, 1.25, 16, 4, 10), (2, 0.25, 16, 4, 2), (4, 1.25, 8, 64, 4),
    (1, 1.25, 3, 16, 1), (4, 1.25, 2, 4, 2)])
def test_capacity_rule(k, cf, t, e, want):
    """qwen2-moe's decode tick of 8 rows: max(4, 1.25·4·8/64 = 0.625) =
    4; the cap at T when k exceeds it."""
    assert tmoe.capacity(k, cf, t, e) == want


def _padded_cfgs():
    small = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=128)
    jcfg = jax_config("qwen2-moe-a2.7b").reduced(**small)
    tcfg = get_config("qwen2-moe-a2.7b").reduced(**small)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, num_experts=6, padded_experts=8))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, num_experts=6, padded_experts=8))
    return jcfg, tcfg


def test_padded_experts_are_real_experts():
    jcfg, tcfg = _padded_cfgs()
    assert tcfg.moe.effective_experts == jcfg.moe.effective_experts == 8
    japi = jax_model(jcfg)
    jp = jax.tree.map(np.asarray, unbox(japi.init(jax.random.PRNGKey(0))))
    assert jp["blocks"]["moe"]["wg"]["kernel"].shape == (2, 8, 32, 32)
    tapi = get_model(tcfg)
    fresh = tapi.init(torch.Generator().manual_seed(0), device="cpu")
    assert tuple(fresh["blocks"][0]["moe"]["wg"]["kernel"].shape) == (
        8, 32, 32)
    assert tuple(fresh["blocks"][0]["moe"]["router"]["kernel"].shape) == (
        32, 8)
    tp = params_from_jax(jp, tcfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, 128, (2, 12)).astype(
        np.int32)
    jl, jaux = jax.jit(japi.forward)(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = tapi.forward(tp, {"tokens": torch.from_numpy(toks)},
                            return_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=5e-5)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), **TOL)
    # the padding experts (6 and 7) are drawn like the others and chosen
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(64, 32)).astype(np.float32))
    _, probs = tmoe._router_probs(tp["blocks"][0]["moe"], x)
    chosen = torch.topk(probs, tcfg.moe.top_k, dim=-1).indices
    assert bool((chosen >= tcfg.moe.num_experts).any())
