"""Every arch id the port carries (mirroring tests/test_archs_smoke.py)
against the JAX package on converted parameters.

* Configs: each full config equals the reference's field by field (the
  ``moe`` / ``ssm`` / ``encdec`` / ``frontend`` / ``attention`` blocks as
  dicts; the reference's ``unroll`` is False for every arch), with and
  without ``@inhibitor``, and so do their reduced and depth-cut
  variants' blocks; ``ARCH_IDS``, ``INHIBITOR_APPLICABLE`` and
  ``LONG_CONTEXT_ARCHS`` are the reference's.
* Logits of the reduced configs (2 layers, d 32, d_ff 64, vocab 128; the
  MoE's 4 experts of 32, top 2 or 1, its shared expert of 32; hymba's
  Mamba at inner 64, state 8; the encoder-decoder's 2 + 2 layers; the
  vlm's 16 patch embeddings of 32) against the reference's forward on a
  batch built from its ``input_specs`` (train shape b 2 x 28, as
  tests/test_archs_smoke.py builds one), for every arch and the
  ``@inhibitor`` variants of qwen2-0.5b, qwen2-moe, hymba, seamless and
  llava, and the MoE aux losses beside them.  For the inhibitor, wq and
  wk are scaled by 1/sqrt(head_dim) in every attention of both trees
  (tests/test_torch_model.py says why).
* Decode against forward: qwen2-moe and hymba prefill 5 tokens and decode
  2 on a paged state (page 8, rows on non-contiguous pages) against the
  whole 7-token forward, and against the reference's ``lm_step`` on the
  same state, the Mamba carries included.  MoE capacity ties a batch's
  tokens together (a decode step of 2 tokens has its own capacity), so
  the MoE case takes a capacity factor of E / k = 2, at which no
  assignment is dropped in either call; at the default 1.25 the port
  still equals the reference step for step.
* ``params_from_jax`` carries the expert stacks (L, E, d, f) -> (E, d,
  f) per layer, ``router``, ``shared_gate``, every ``mamba`` leaf and
  ``branch_scale`` across unchanged.
* The training loss: loss, ``xent``, ``moe_lb`` / ``moe_z`` and every
  parameter's gradient against the reference's ``make_loss_fn`` under
  ``jax.grad``, for qwen2-moe and hymba.

Tolerance: float32 on both sides; logits rtol 1e-5, atol 5e-5 (as
tests/test_torch_model.py), decode against forward 2e-4 (the reference
smoke test's own is 2e-3), gradients 1e-4 of their norm.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import get_config as jax_config
from repro.models import transformer as jtfm
from repro.models.registry import get_model as jax_model
from repro.nn.module import unbox
from repro.train.step import make_loss_fn as jax_make_loss_fn
from repro_torch import configs as tconfigs
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as ttfm
from repro_torch.models.registry import get_model
from repro_torch.train.step import make_grad_fn
from repro_torch.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=5e-5)
SMALL = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=128)
PORTED = jconfigs.ARCH_IDS
INHIBITOR_ARCHS = ("qwen2-0.5b@inhibitor", "qwen2-moe-a2.7b@inhibitor",
                   "hymba-1.5b@inhibitor", "seamless-m4t-large-v2@inhibitor",
                   "llava-next-mistral-7b@inhibitor")
# the layer stacks of a parameter tree and their attentions
STACKS = {"blocks": ("attn",), "encoder": ("attn",),
          "decoder": ("self_attn", "cross_attn")}


def _scale_qk(jp, factor):
    out = dict(jp)
    for stack, attns in STACKS.items():
        if stack not in jp:
            continue
        st = dict(jp[stack])
        for name in attns:
            attn = dict(st[name])
            for w in ("wq", "wk"):
                attn[w] = dict(attn[w], kernel=attn[w]["kernel"] * factor)
            st[name] = attn
        out[stack] = st
    return out


def _live(jp, cfg, seed=0):
    """Draw what init leaves constant: the hybrid branch scales, the Mamba
    conv and dt biases (so every term reaches the logits)."""
    if cfg.family != "hybrid":
        return jp
    rng = np.random.default_rng(seed)
    blocks = dict(jp["blocks"])
    m = dict(blocks["mamba"])
    m["conv_b"] = rng.normal(size=m["conv_b"].shape).astype(np.float32)
    m["dt_proj"] = dict(m["dt_proj"], bias=(0.5 * rng.normal(
        size=m["dt_proj"]["bias"].shape) - 1.0).astype(np.float32))
    blocks["mamba"] = m
    blocks["branch_scale"] = rng.uniform(
        0.5, 1.5, blocks["branch_scale"].shape).astype(np.float32)
    return dict(jp, blocks=blocks)


def _cfgs(arch, **moe):
    jcfg, tcfg = jax_config(arch).reduced(**SMALL), get_config(
        arch).reduced(**SMALL)
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, **moe))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _models(arch, capacity_factor=None):
    """(jax cfg, jax api, jax params, port cfg, port api, port params)."""
    moe = {} if capacity_factor is None else dict(
        capacity_factor=capacity_factor)
    jcfg, tcfg = _cfgs(arch, **moe)
    japi = jax_model(jcfg)
    jp = jax.tree.map(np.asarray, unbox(jax.jit(japi.init)(
        jax.random.PRNGKey(0))))
    jp = _live(jp, jcfg)
    if jcfg.attention.mechanism.startswith("inhibitor"):
        jp = _scale_qk(jp, jcfg.attention.head_dim ** -0.5)
    tp = params_from_jax(jp, tcfg, device="cpu")
    japi = japi._replace(step=jax.jit(japi.step),
                         forward=jax.jit(japi.forward))
    return jcfg, japi, jp, tcfg, get_model(tcfg), tp


def _asdict(x):
    return None if x is None else dataclasses.asdict(x)


@pytest.mark.parametrize("arch", PORTED + INHIBITOR_ARCHS)
def test_full_config_matches_reference(arch):
    ref, port = jax_config(arch), get_config(arch)
    blocks = ("attention", "moe", "ssm", "encdec", "frontend")
    for f in dataclasses.fields(port):
        if f.name in blocks:
            assert _asdict(getattr(port, f.name)) == _asdict(
                getattr(ref, f.name)), f.name
        else:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert {f.name for f in dataclasses.fields(ref)} - {
        f.name for f in dataclasses.fields(port)} == {"unroll"}
    assert not ref.unroll
    if port.moe is not None:
        assert port.moe.effective_experts == ref.moe.effective_experts
    for red_ref, red_port in ((ref.reduced(**SMALL), port.reduced(**SMALL)),
                              (ref.with_layers(3), port.with_layers(3))):
        assert red_port.num_layers == red_ref.num_layers
        for name in blocks:
            assert _asdict(getattr(red_port, name)) == _asdict(
                getattr(red_ref, name)), name


def test_arch_lists_match_reference():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.INHIBITOR_APPLICABLE == jconfigs.INHIBITOR_APPLICABLE
    assert tconfigs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    assert not hasattr(tconfigs, "NOT_PORTED")


def _spec_batch(japi, seed=1, b=2, s=28):
    """A forward batch from the reference's ``input_specs`` at a train
    shape (labels left out), as tests/test_archs_smoke.py builds one."""
    from repro.configs.base import ShapeConfig

    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in japi.input_specs(ShapeConfig("t", s, b,
                                                   "train")).items():
        if name == "labels":
            continue
        if spec.dtype == jnp.int32:
            out[name] = rng.integers(0, 128, spec.shape).astype(np.int32)
        else:
            out[name] = rng.normal(size=spec.shape).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", PORTED + INHIBITOR_ARCHS)
def test_forward_logits_match_reference(arch):
    jcfg, japi, jp, tcfg, tapi, tp = _models(arch)
    nb = _spec_batch(japi)
    jl, jaux = japi.forward(jp, {k: jnp.asarray(v) for k, v in nb.items()})
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    if tcfg.family == "ssm":
        tl = tapi.forward(tp, batch)
    else:
        tl, taux = tapi.forward(tp, batch, return_aux=True)
        np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), **TOL)
        assert (float(taux.abs().sum()) > 0) == (tcfg.moe is not None)
    assert bool(torch.isfinite(tl).all())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("arch,capacity_factor", [
    ("qwen2-moe-a2.7b", 2.0), ("qwen2-moe-a2.7b", None),
    ("hymba-1.5b", None), ("hymba-1.5b@inhibitor", None)])
def test_decode_matches_forward_and_reference(arch, capacity_factor):
    jcfg, japi, jp, tcfg, tapi, tp = _models(arch, capacity_factor)
    toks = np.random.default_rng(2).integers(0, 128, (2, 7)).astype(
        np.int32)
    kw = dict(paged=True, page_size=8)
    js = jtfm.init_states(jcfg, 2, 32, **kw)
    ts = ttfm.init_states(tcfg, 2, 32, device="cpu", **kw)
    tab = np.asarray([[3, 1, 5, 0], [2, 4, 6, 7]], np.int32)
    js = js._replace(kv=js.kv._replace(block_tables=jnp.broadcast_to(
        jnp.asarray(tab)[None], js.kv.block_tables.shape)))
    ts.kv.block_tables.copy_(torch.from_numpy(tab))
    outs = []
    for lo, hi in ((0, 5), (5, 6), (6, 7)):
        jl, js = japi.step(jp, jnp.asarray(toks[:, lo:hi]), js, None)
        tl, ts = tapi.step(tp, torch.from_numpy(toks[:, lo:hi]), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        outs.append(tl)
    if tcfg.family == "hybrid":
        np.testing.assert_allclose(ts.ssm.numpy(), np.asarray(js.ssm),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ts.conv.numpy(), np.asarray(js.conv),
                                   rtol=1e-5, atol=1e-5)
    assert ts.kv.length.tolist() == [7, 7]
    if tcfg.moe is not None and capacity_factor is None:
        return      # capacity differs between the calls: see the docstring
    full = tapi.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_conversion_carries_moe_and_mamba_leaves_unchanged():
    for arch in ("qwen2-moe-a2.7b", "hymba-1.5b"):
        jcfg, _, jp, tcfg, tapi, tp = _models(arch)
        fresh = tapi.init(torch.Generator().manual_seed(0), device="cpu")
        shapes = jax.tree.map(lambda a: tuple(a.shape[1:]), jp["blocks"])
        assert jax.tree.map(lambda t: tuple(t.shape),
                            fresh["blocks"][0]) == shapes
        jb = jp["blocks"]
        for i, tb in enumerate(tp["blocks"]):
            if arch.startswith("qwen2-moe"):
                m = jcfg.moe
                assert jb["moe"]["wg"]["kernel"].shape == (
                    2, m.num_experts, 32, m.expert_hidden_dim)
                names = [("moe", "wg", "kernel"), ("moe", "wu", "kernel"),
                         ("moe", "wd", "kernel"), ("moe", "router", "kernel"),
                         ("moe", "shared_gate", "kernel"),
                         ("moe", "shared", "wg", "kernel")]
            else:
                names = [("mamba", k) for k in ("conv_w", "conv_b", "A_log",
                                                "D")]
                names += [("mamba", k, "kernel") for k in
                          ("in_proj", "x_proj", "dt_proj", "out_proj")]
                names += [("mamba", "dt_proj", "bias"), ("branch_scale",)]
            for path in names:
                j, t = jb, tb
                for k in path:
                    j, t = j[k], t[k]
                np.testing.assert_array_equal(t.numpy(), np.asarray(j)[i])
                assert t.dtype == torch.float32


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "hymba-1.5b"])
def test_loss_metrics_and_gradients_match_reference(arch):
    jcfg, japi, jp, tcfg, tapi, tp = _models(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 128, (2, 12)).astype(np.int32)
    labels = rng.integers(0, 128, (2, 12)).astype(np.int32)
    labels[0, :3] = -1
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jloss, jm), jgrads = jax.value_and_grad(
        jax_make_loss_fn(jax_model(jcfg)), has_aux=True)(
            jax.tree.map(jnp.asarray, jp), jbatch)
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    grads, tm = make_grad_fn(tapi)(params, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert set(tm) == set(jm)
    assert ("moe_lb" in tm) == (tcfg.moe is not None)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                           device="cpu")
    got_leaves, want_leaves = tree_leaves(grads), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        err = torch.linalg.vector_norm(g - w).item()
        assert err <= 1e-4 * max(torch.linalg.vector_norm(w).item(), 1e-6)
