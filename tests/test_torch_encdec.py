"""The encoder-decoder family (``seamless-m4t-large-v2``) of the port
against the JAX package on converted parameters.

* Model: the reduced config (2 + 2 layers, d 32, d_ff 64, vocab 128, 4 /
  2 heads of 16, 64 source frames of 32), its norm scales and every bias
  drawn from a numpy seed so that each term reaches the logits; for the
  inhibitor, wq and wk of all three attentions scaled by 1/sqrt(16)
  (tests/test_torch_model.py says why).  ``blocked_threshold`` is 64 in
  both configs, so the non-causal encoder and the causal decoder take the
  ``blocked`` inhibitor backend on the CPU; ``chunked_threshold`` 16 in
  one case, so the inhibitor's cross-attention takes ``chunked``.
* ``encode``, ``decode_train``, ``forward_train`` (the registry's
  forward) and ``decode_step`` against the reference, for both
  mechanisms; decode against teacher forcing (greedy tokens, then the
  whole sequence teacher-forced); the training loss and every gradient
  against ``jax.grad`` of the reference's ``make_loss_fn``.
* Cross-attention: ``apply_attention(x_kv=...)`` against the reference's,
  with and without a cache (whose valid length masks the keys); the plan
  it makes is the reference's ``plan_attention`` for ``is_cross``, never
  a mask-free backend, on the CPU and on the card alike.
* Remat: each layer is checkpointed only under ``"full"``; ``"dots"``
  runs unchecked, as in the reference, and both give the gradients of
  ``"none"``.
* ``params_from_jax`` splits the stacked ``encoder`` / ``decoder`` trees
  and carries ``frontend_proj`` across unchanged; ``init_states`` keeps
  one scalar cursor per layer.

Tolerance: float32 on both sides; logits rtol 1e-5, atol 5e-5; decode
against the forward 2e-4; gradients 1e-4 of their norm.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import attention as jattn
from repro.core import mechanism as jmech
from repro.models import encdec as jencdec
from repro.models.registry import get_model as jax_model
from repro.nn.module import unbox
from repro.train.step import make_loss_fn as jax_make_loss_fn
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import attention as tattn
from repro_torch.core import mechanism as tmech
from repro_torch.models import encdec as tencdec
from repro_torch.models import transformer as ttfm
from repro_torch.models.registry import get_model
from repro_torch.train.step import make_grad_fn
from repro_torch.tree import tree_leaves

ARCH = "seamless-m4t-large-v2"
TOL = dict(rtol=1e-5, atol=5e-5)
SMALL = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=128)
B, SRC, TGT = 2, 24, 12
ARMS = [ARCH, f"{ARCH}@inhibitor"]
ATTN = ("attn", "self_attn", "cross_attn")


def _cfg(get, arch, **attn):
    cfg = get(arch).reduced(**SMALL)
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, blocked_threshold=64, **attn))


def _live(jp, seed=0):
    """Every bias and norm scale drawn from a numpy seed (init leaves them
    0 and 1)."""
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree)
        if name == "bias":
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a

    return walk(jp)


def _scale_qk(jp, factor):
    out = dict(jp)
    for stack in ("encoder", "decoder"):
        st = dict(out[stack])
        for a in ATTN:
            if a in st:
                st[a] = {k: (dict(v, kernel=v["kernel"] * factor)
                             if k in ("wq", "wk") else v)
                         for k, v in st[a].items()}
        out[stack] = st
    return out


@functools.lru_cache(maxsize=None)
def _models(arch, chunked_threshold=None):
    """(jax cfg, jax params, port cfg, port params)."""
    kw = {} if chunked_threshold is None else dict(
        chunked_threshold=chunked_threshold)
    jcfg, tcfg = _cfg(jax_config, arch, **kw), _cfg(get_config, arch, **kw)
    jp = _live(jax.tree.map(np.asarray, unbox(jax_model(jcfg).init(
        jax.random.PRNGKey(0)))))
    if jcfg.attention.mechanism.startswith("inhibitor"):
        jp = _scale_qk(jp, jcfg.attention.head_dim ** -0.5)
    return jcfg, jp, tcfg, params_from_jax(jp, tcfg, device="cpu")


def _inputs(seed=1, tgt=TGT):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, SRC, 32)).astype(np.float32)
    tokens = rng.integers(0, 128, (B, tgt)).astype(np.int32)
    return frames, tokens


def _t(a):
    return torch.from_numpy(np.array(a))


CASES = [(a, None) for a in ARMS] + [(f"{ARCH}@inhibitor", 16)]


@pytest.mark.parametrize("arch,chunked", CASES)
def test_encode_decode_and_forward_match_reference(arch, chunked):
    jcfg, jp, tcfg, tp = _models(arch, chunked)
    frames, tokens = _inputs()
    jparams = jax.tree.map(jnp.asarray, jp)
    jmem = jencdec.encode(jparams, jcfg, jnp.asarray(frames))
    with torch.no_grad():
        tmem = tencdec.encode(tp, tcfg, _t(frames))
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), **TOL)
    assert float(tmem.abs().max()) > 0.1
    # the decoder from one shared memory, then the whole forward
    jl = jencdec.decode_train(jparams, jcfg, jnp.asarray(np.asarray(jmem)),
                              jnp.asarray(tokens))
    with torch.no_grad():
        tl = tencdec.decode_train(tp, tcfg, _t(np.asarray(jmem)), _t(tokens))
        fl, aux = get_model(tcfg).forward(
            tp, {"frames": _t(frames), "tokens": _t(tokens)},
            return_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jf, jaux = jax_model(jcfg).forward(jparams, {
        "frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(fl.numpy(), np.asarray(jf), **TOL)
    np.testing.assert_array_equal(aux.numpy(), np.asarray(jaux))
    assert bool(torch.isfinite(fl).all()) and float(fl.std()) > 0.01


@pytest.mark.parametrize("arch,chunked", CASES)
def test_planner_takes_the_reference_backends(arch, chunked, monkeypatch):
    """The plans each attention makes in the forward: blocked (the
    inhibitor's structural backend) or fused for the self-attentions,
    chunked / fused for the cross-attention, as the reference plans the
    same shapes."""
    jcfg, _, tcfg, tp = _models(arch, chunked)
    frames, tokens = _inputs()
    seen = []
    orig = tattn.plan_attention

    def spy(cfg, shapes):
        plan = orig(cfg, shapes)
        seen.append((cfg.causal, shapes.is_cross, shapes.n_q, shapes.n_k,
                     plan.backend))
        return plan

    monkeypatch.setattr(tattn, "plan_attention", spy)
    with torch.no_grad():
        tencdec.forward_train(tp, tcfg, _t(frames), _t(tokens))
    L = 2
    assert len(seen) == 3 * L
    for causal, cross, n_q, n_k, backend in seen:
        jat = dataclasses.replace(jcfg.attention, causal=causal)
        want = jmech.plan_attention(jat, jmech.AttnShapes(
            batch=B, n_q=n_q, n_k=n_k, num_heads=4, num_kv_heads=2,
            head_dim=16, is_cross=cross, platform="cpu")).backend
        assert backend == want
        if cross:
            assert backend in ("chunked", "fused")
    inhibitor = arch.endswith("@inhibitor")
    by_kind = {(c, x): b for c, x, _, _, b in seen}
    assert by_kind[(False, False)] == ("blocked" if inhibitor else "fused")
    assert by_kind[(True, False)] == ("blocked" if inhibitor else "fused")
    assert by_kind[(False, True)] == ("chunked" if chunked else "fused")


@pytest.mark.parametrize("mech", ["dotprod", "inhibitor"])
@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_cross_attention_plans_never_a_mask_free_backend(mech, platform):
    cfg = dataclasses.replace(get_config(f"{ARCH}@{mech}").attention,
                              causal=False, use_rope=False)
    jcfg = dataclasses.replace(jax_config(f"{ARCH}@{mech}").attention,
                               causal=False, use_rope=False)
    for n_q, n_k, has_cache in ((1, 4096, False), (1024, 4096, False),
                                (1024, 8192, False), (4096, 4096, False),
                                (8, 8, True)):
        kw = dict(batch=2, n_q=n_q, n_k=n_k, num_heads=16, num_kv_heads=16,
                  head_dim=64, is_cross=True, has_cache=has_cache)
        plan = tmech.plan_attention(cfg, tmech.AttnShapes(
            platform=platform, **kw))
        assert plan.backend not in tmech.MASK_FREE_BACKENDS
        assert plan.backend in ("chunked", "fused")
        want = jmech.plan_attention(jcfg, jmech.AttnShapes(
            platform="tpu" if platform == "cuda" else "cpu", **kw))
        assert plan.backend == want.backend
        # the self-attention at the same shape takes the kernel on the card
        if platform == "cuda" and n_q * n_k >= 1 << 20:
            self_plan = tmech.plan_attention(cfg, tmech.AttnShapes(
                platform=platform, **dict(kw, is_cross=False)))
            assert self_plan.backend == "pallas"


@pytest.mark.parametrize("mech", ["dotprod", "inhibitor"])
@pytest.mark.parametrize("cached", [False, True])
def test_cross_attention_matches_reference(mech, cached):
    """One cross-attention layer on converted parameters: K and V from
    x_kv, no RoPE (positions would change nothing), and with a cache the
    keys masked by its valid length (per-slot cursors)."""
    cfg_j = dataclasses.replace(jax_config(f"{ARCH}@{mech}").reduced(
        **SMALL).attention, causal=False, use_rope=True)
    cfg_t = dataclasses.replace(get_config(f"{ARCH}@{mech}").reduced(
        **SMALL).attention, causal=False, use_rope=True)
    jp = _live(jax.tree.map(np.asarray, unbox(jattn.init_attention(
        jax.random.PRNGKey(3), cfg_j, 32))), seed=3)
    if mech == "inhibitor":
        for w in ("wq", "wk"):
            jp[w] = dict(jp[w], kernel=jp[w]["kernel"] * 0.25)
    tp = jax.tree.map(_t, jp)
    rng = np.random.default_rng(4)
    n_q = 6
    n_kv = n_q if cached else 20
    x = rng.normal(size=(B, n_q, 32)).astype(np.float32)
    x_kv = rng.normal(size=(B, n_kv, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(n_q)[None] + 7, (B, n_q)).astype(np.int32)
    jcache = tcache = None
    if cached:
        lengths = np.asarray([3, 10], np.int32)
        kc = rng.normal(size=(B, 16, 2, 16)).astype(np.float32)
        vc = rng.normal(size=(B, 16, 2, 16)).astype(np.float32)
        jcache = jattn.KVCache(jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(lengths))
        tcache = tattn.KVCache(_t(kc.copy()), _t(vc.copy()), _t(lengths))
    jy, jc = jattn.apply_attention(
        jax.tree.map(jnp.asarray, jp), cfg_j, jnp.asarray(x),
        x_kv=jnp.asarray(x_kv), positions=jnp.asarray(pos), cache=jcache)
    ty, tc = tattn.apply_attention(tp, cfg_t, _t(x), x_kv=_t(x_kv),
                                   positions=_t(pos), cache=tcache)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert float(ty.abs().max()) > 0.05
    if cached:
        np.testing.assert_array_equal(tc.length.numpy(),
                                      np.asarray(jc.length))
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
        # the mask bites: the keys past each cursor change nothing
        tcache2 = tattn.KVCache(tcache.k.clone(), tcache.v.clone(),
                                _t(lengths))
        tcache2.v[0, 9:] = 1e3
        ty2, _ = tattn.apply_attention(tp, cfg_t, _t(x), x_kv=_t(x_kv),
                                       positions=_t(pos), cache=tcache2)
        np.testing.assert_allclose(ty2[0].numpy(), ty[0].numpy(), **TOL)
    else:
        # RoPE never applies: other positions give the same output
        ty3, _ = tattn.apply_attention(tp, cfg_t, _t(x), x_kv=_t(x_kv),
                                       positions=_t(pos * 0 + 100))
        np.testing.assert_array_equal(ty3.numpy(), ty.numpy())


@pytest.mark.parametrize("arch", ARMS)
def test_decode_steps_match_reference_and_teacher_forcing(arch):
    """Greedy decode (a 3-token prompt, then 5 single-token steps) on the
    port's cache against the reference's decode_step on the same memory
    and tokens, then against the teacher-forced decoder over the
    generated sequence."""
    jcfg, jp, tcfg, tp = _models(arch)
    frames, tokens = _inputs(seed=5)
    jparams = jax.tree.map(jnp.asarray, jp)
    mem = np.asarray(jencdec.encode(jparams, jcfg, jnp.asarray(frames)))
    js = jencdec.init_states(jcfg, B, 16)
    ts = tencdec.init_states(tcfg, B, 16, device="cpu")
    assert tuple(ts.kv.length.shape) == (2,) and ts.kv.k.shape == (
        2, B, 16, 2, 16)
    storage = (ts.kv.k.data_ptr(), ts.kv.v.data_ptr())
    seq = tokens[:, :3]
    feed = seq
    outs = []
    jstep = jax.jit(functools.partial(jencdec.decode_step, cfg=jcfg))
    for _ in range(6):
        jl, js = jstep(jparams, memory=jnp.asarray(mem),
                       tokens=jnp.asarray(feed), states=js)
        with torch.no_grad():
            tl, ts = get_model(tcfg).step(tp, _t(feed), ts,
                                          {"memory": _t(mem)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        outs.append(tl)
        feed = tl[:, -1].argmax(-1, keepdim=True).numpy().astype(np.int32)
        seq = np.concatenate([seq, feed], axis=1)
    assert ts.kv.length.tolist() == [8, 8]
    assert (ts.kv.k.data_ptr(), ts.kv.v.data_ptr()) == storage
    np.testing.assert_allclose(ts.kv.k.numpy(), np.asarray(js.kv.k), **TOL)
    with torch.no_grad():
        full = tencdec.decode_train(tp, tcfg, _t(mem), _t(seq[:, :8]))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARMS)
def test_loss_and_gradients_match_reference(arch):
    jcfg, jp, tcfg, tp = _models(arch)
    frames, tokens = _inputs(seed=6)
    labels = np.random.default_rng(7).integers(0, 128, tokens.shape).astype(
        np.int32)
    labels[1, :4] = -1
    (jloss, jm), jgrads = jax.value_and_grad(
        jax_make_loss_fn(jax_model(jcfg)), has_aux=True)(
            jax.tree.map(jnp.asarray, jp), {
                "frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens),
                "labels": jnp.asarray(labels)})
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    grads, tm = make_grad_fn(get_model(tcfg))(params, {
        "frames": _t(frames), "tokens": _t(tokens), "labels": _t(labels)})
    assert set(tm) == set(jm) == {"xent", "loss"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                           device="cpu")
    got_leaves, want_leaves = tree_leaves(grads), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves) == len(tree_leaves(tp))
    # under Softmax a query's scores are shift-invariant, so the key
    # projection's bias has an analytic gradient of 0 in every attention:
    # both sides hold rounding there, below 1e-6
    zero = {id(t) for stack in ("encoder", "decoder") for layer in
            grads[stack] for a in ATTN if a in layer
            for t in [layer[a]["wk"]["bias"]]} if "@" not in arch else set()
    for g, w in zip(got_leaves, want_leaves):
        err = torch.linalg.vector_norm(g - w).item()
        wn = torch.linalg.vector_norm(w).item()
        if id(g) in zero:
            assert wn < 1e-6 and torch.linalg.vector_norm(g).item() < 1e-6
            continue
        assert wn > 1e-6 and err <= 1e-4 * wn
    assert len(zero) == (0 if "@" in arch else 6)
    # the encoder's and the cross-attention's weights get gradients
    assert float(grads["encoder"][0]["attn"]["wq"]["kernel"].abs().max()) > 0
    assert float(grads["decoder"][1]["cross_attn"]["wk"]["kernel"]
                 .abs().max()) > 0


@pytest.mark.parametrize("remat", ["none", "full", "dots", "offload"])
def test_remat_checkpoints_layers_only_under_full(remat, monkeypatch):
    jcfg, jp, tcfg, tp = _models(ARCH)
    cfg = dataclasses.replace(tcfg, remat=remat)
    calls = []
    orig = ttfm.remat_block

    def counting(c, fn, *args):
        calls.append(fn.__name__)
        return orig(c, fn, *args)

    monkeypatch.setattr(ttfm, "remat_block", counting)
    frames, tokens = _inputs(seed=8)
    labels = np.random.default_rng(9).integers(0, 128, tokens.shape).astype(
        np.int32)
    batch = {"frames": _t(frames), "tokens": _t(tokens), "labels": _t(labels)}
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    grads, _ = make_grad_fn(get_model(cfg))(params, batch)
    assert calls == (["_enc_block"] * 2 + ["_dec_block"] * 2
                     if remat == "full" else [])
    ref, _ = make_grad_fn(get_model(dataclasses.replace(
        tcfg, remat="none")))(params, batch)
    for g, r in zip(tree_leaves(grads), tree_leaves(ref)):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        make_grad_fn(get_model(dataclasses.replace(tcfg, remat="bogus")))(
            params, batch)


def test_conversion_splits_the_stacks_and_keeps_the_frontend():
    jcfg, jp, tcfg, tp = _models(ARCH)
    fresh = get_model(tcfg).init(torch.Generator().manual_seed(0),
                                 device="cpu")
    assert set(tp) == set(fresh) == set(jp)
    for stack in ("encoder", "decoder"):
        assert len(tp[stack]) == 2
        shapes = jax.tree.map(lambda a: tuple(a.shape[1:]), jp[stack])
        assert jax.tree.map(lambda t: tuple(t.shape),
                            fresh[stack][0]) == shapes
        for i in range(2):
            np.testing.assert_array_equal(
                tp[stack][i]["ffn"]["wi"]["bias"].numpy(),
                jp[stack]["ffn"]["wi"]["bias"][i])
    np.testing.assert_array_equal(tp["frontend_proj"]["kernel"].numpy(),
                                  jp["frontend_proj"]["kernel"])
    np.testing.assert_array_equal(tp["frontend_proj"]["bias"].numpy(),
                                  jp["frontend_proj"]["bias"])
    assert tp["frontend_proj"]["kernel"].shape == (32, 32)
    with pytest.raises(ValueError, match="scalar cursor"):
        tencdec.init_states(tcfg, 2, 8, per_slot=True, device="cpu")
