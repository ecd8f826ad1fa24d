"""The vlm family (``llava-next-mistral-7b``) of the port against the JAX
package, ``input_specs`` for every family, and where the engine and the
training launcher stand on the new families.

* Model: the reduced config (2 layers, d 32, d_ff 64, vocab 128, 4 / 2
  heads of 16; a frontend of 2 tiles x 8 patches of 32), ``frontend_proj``
  with a bias drawn from a numpy seed; for the inhibitor, wq and wk scaled
  by 1/sqrt(16) (tests/test_torch_model.py says why).
* ``lm_forward`` with ``extra_embeds`` (16 patch embeddings before 12
  text tokens) against the reference's, logits over all 28 positions; the
  image positions change the text logits; without image embeddings the
  forward is the dense family's.
* ``input_specs`` of every arch id, full and reduced, at the reference's
  four shapes and a small one of each kind: the same names, shapes and
  dtypes as the reference's ShapeDtypeStructs, as ``meta`` tensors.
* The loss with labels over the whole sequence (``_vlm_specs``) and with
  text labels only (``_align_labels`` pads the image positions with -1),
  and every gradient, against ``jax.grad`` of the reference's
  ``make_loss_fn``.
* The reduced llava served through the port's engine: greedy tokens
  equal to the reference engine's on the same text requests under every
  warm-up policy (paged, bucketed, the prefix cache hit).
* The engine refuses ``encdec`` with a ``ValueError``, and so does
  ``launch.train`` (the token pipeline has no frames); ``launch.serve``
  serves llava and ``launch.train`` trains it, text-only, on the CPU.

Tolerance: float32 on both sides; logits rtol 1e-5, atol 5e-5;
gradients 1e-4 of their norm.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.configs import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.nn.module import unbox
from repro.serve import engine as jengine
from repro.train.step import make_loss_fn as jax_make_loss_fn
from repro_torch import configs as tconfigs
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.serve import engine as tengine
from repro_torch.train.step import make_grad_fn
from repro_torch.tree import tree_leaves

ARCH = "llava-next-mistral-7b"
ARMS = [ARCH, f"{ARCH}@inhibitor"]
TOL = dict(rtol=1e-5, atol=5e-5)
SMALL = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=128)
N_IMG, TEXT = 16, 12
GEOM = dict(max_batch=2, max_len=64, page_size=8, prefill_chunk=8)
PROMPTS, NEW, SHARED = (21, 18, 27), (6, 9, 5), 16


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(jax cfg, jax params (numpy), port cfg, port params)."""
    jcfg, tcfg = jax_config(arch).reduced(**SMALL), get_config(arch).reduced(
        **SMALL)
    jp = jax.tree.map(np.asarray, unbox(jax_model(jcfg).init(
        jax.random.PRNGKey(0))))
    rng = np.random.default_rng(0)
    jp["frontend_proj"] = dict(jp["frontend_proj"], bias=(0.1 * rng.normal(
        size=jp["frontend_proj"]["bias"].shape)).astype(np.float32))
    if jcfg.attention.mechanism.startswith("inhibitor"):
        attn = dict(jp["blocks"]["attn"])
        for w in ("wq", "wk"):
            attn[w] = dict(attn[w], kernel=attn[w]["kernel"] * 0.25)
        jp = dict(jp, blocks=dict(jp["blocks"], attn=attn))
    return jcfg, jp, tcfg, params_from_jax(jp, tcfg, device="cpu")


def _batch(seed, text=TEXT, b=2):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 128, (b, text)).astype(np.int32),
            "image_embeds": rng.normal(size=(b, N_IMG, 32)).astype(
                np.float32)}


@pytest.mark.parametrize("arch", ARMS)
def test_forward_with_image_embeddings_matches_reference(arch):
    jcfg, jp, tcfg, tp = _models(arch)
    assert tp["frontend_proj"]["kernel"].shape == (32, 32)
    batch = _batch(1)
    jl, jaux = jax_model(jcfg).forward(jax.tree.map(jnp.asarray, jp),
                                       jax.tree.map(jnp.asarray, batch))
    api = get_model(tcfg)
    with torch.no_grad():
        tl, taux = api.forward(tp, jax.tree.map(_t, batch), return_aux=True)
        text_only = api.forward(tp, {"tokens": _t(batch["tokens"])})
    assert tuple(tl.shape) == (2, N_IMG + TEXT, 128)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))
    # the image positions reach the text logits; without them the forward
    # is the reference's text-only one
    assert float((tl[:, N_IMG:] - text_only).abs().max()) > 1e-3
    jt, _ = jax_model(jcfg).forward(jax.tree.map(jnp.asarray, jp),
                                    {"tokens": jnp.asarray(batch["tokens"])})
    np.testing.assert_allclose(text_only.numpy(), np.asarray(jt), **TOL)


def _shapes():
    small = [jbase.ShapeConfig(f"small_{k}", 40, 2, k)
             for k in ("train", "prefill", "decode")]
    short = [jbase.ShapeConfig(f"short_{k}", 8, 3, k)
             for k in ("train", "prefill", "decode")]
    return list(jbase.SHAPES) + small + short


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_input_specs_match_reference(arch):
    assert tconfigs.SHAPES_BY_NAME.keys() == jbase.SHAPES_BY_NAME.keys()
    for reduced in (False, True):
        jcfg, tcfg = jax_config(arch), get_config(arch)
        if reduced:
            jcfg, tcfg = jcfg.reduced(**SMALL), tcfg.reduced(**SMALL)
        japi, tapi = jax_model(jcfg), get_model(tcfg)
        for js in _shapes():
            ts = tconfigs.ShapeConfig(js.name, js.seq_len, js.global_batch,
                                      js.kind)
            assert ts.is_decode == js.is_decode
            want = japi.input_specs(js)
            got = tapi.input_specs(ts)
            assert list(got) == list(want), (arch, js)
            for k, spec in want.items():
                assert tuple(got[k].shape) == tuple(spec.shape), (arch, js, k)
                assert str(got[k].dtype) == f"torch.{spec.dtype}"
                assert got[k].device.type == "meta"


@pytest.mark.parametrize("labels_cover", ["sequence", "text", "no image"])
@pytest.mark.parametrize("arch", ARMS)
def test_loss_and_gradients_match_reference(arch, labels_cover):
    """Labels over image and text positions (the reference's specs; image
    positions at -1), or over the text alone, which the loss aligns by
    padding the image positions with -1; or a text-only batch (the
    training launcher's), where ``frontend_proj`` gets a zero gradient
    on both sides."""
    jcfg, jp, tcfg, tp = _models(arch)
    shape = jbase.ShapeConfig("t", N_IMG + TEXT, 2, "train")
    specs = jax_model(jcfg).input_specs(shape)
    assert specs["tokens"].shape == (2, TEXT)
    batch = _batch(2)
    rng = np.random.default_rng(3)
    if labels_cover == "sequence":
        labels = rng.integers(0, 128, specs["labels"].shape).astype(np.int32)
        labels[:, :N_IMG] = -1
    else:
        labels = rng.integers(0, 128, (2, TEXT)).astype(np.int32)
    labels[0, -2:] = -1
    batch["labels"] = labels
    if labels_cover == "no image":
        del batch["image_embeds"]
    (jloss, jm), jgrads = jax.value_and_grad(
        jax_make_loss_fn(jax_model(jcfg)), has_aux=True)(
            jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    grads, tm = make_grad_fn(get_model(tcfg))(params,
                                              jax.tree.map(_t, batch))
    assert set(tm) == set(jm) == {"xent", "loss"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg,
                           device="cpu")
    got_leaves, want_leaves = tree_leaves(grads), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves) == len(tree_leaves(tp))
    unused = ({id(t) for t in grads["frontend_proj"].values()}
              if labels_cover == "no image" else set())
    for g, w in zip(got_leaves, want_leaves):
        if id(g) in unused:
            assert not g.any() and not w.any()
            continue
        err = torch.linalg.vector_norm(g - w).item()
        wn = torch.linalg.vector_norm(w).item()
        assert wn > 1e-6 and err <= 1e-4 * wn
    assert len(unused) == (2 if labels_cover == "no image" else 0)


@pytest.mark.parametrize("images", [True, False])
def test_gradient_raises_on_a_parameter_the_loss_does_not_reach(images):
    """Only the frontend projection of a batch with no image embeddings
    may miss the loss: any other parameter cut out of the graph raises
    instead of training on a zero gradient."""
    _, _, tcfg, tp = _models(ARMS[0])
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    params["stray"] = {"kernel": torch.zeros(3, requires_grad=True)}
    batch = jax.tree.map(_t, _batch(2))
    batch["labels"] = torch.zeros((2, TEXT), dtype=torch.int32)
    if not images:
        del batch["image_embeds"]
    with pytest.raises(RuntimeError, match=r"shape \(3,\) does not reach"):
        make_grad_fn(get_model(tcfg))(params, batch)


@functools.lru_cache(maxsize=None)
def _reference_tokens():
    jcfg, jp, _, _ = _models(ARCH)
    eng = jengine.Engine(jax_model(jcfg), jax.tree.map(jnp.asarray, jp),
                         jengine.EngineConfig(**GEOM))
    reqs = _requests(jengine)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [r.output for r in reqs], eng.counters["prefix_hit_tokens"]


def _requests(mod):
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 128, (SHARED,)).astype(np.int32)
    return [mod.Request(i, np.concatenate([shared, rng.integers(
        0, 128, (n - SHARED,)).astype(np.int32)]), max_new_tokens=m)
        for i, (n, m) in enumerate(zip(PROMPTS, NEW))]


@pytest.mark.parametrize("warmup", ["none", "decode", "serve"])
def test_engine_serves_text_prompts_as_the_reference(warmup):
    tokens, hits = _reference_tokens()
    _, _, tcfg, tp = _models(ARCH)
    eng = tengine.Engine(get_model(tcfg), tp, tengine.EngineConfig(
        **dict(GEOM, warmup=warmup)), device="cpu")
    reqs = _requests(tengine)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert [r.output for r in reqs] == tokens
    assert [len(t) for t in tokens] == list(NEW)
    assert eng.paged and eng._bucketed and eng.prefix is not None
    assert eng.counters["prefix_hit_tokens"] == hits > 0


def test_engine_and_train_launcher_refuse_the_encoder_decoder():
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    cfg = get_config("seamless-m4t-large-v2").reduced(**SMALL)
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="memory"):
        tengine.Engine(api, params, tengine.EngineConfig(**GEOM),
                       device="cpu")
    with pytest.raises(ValueError, match="memory"):
        launch_serve.main(["--arch", "seamless-m4t-large-v2", "--device",
                           "cpu"])
    with pytest.raises(ValueError, match="no frames"):
        launch_train.run(["--arch", "seamless-m4t-large-v2", "--device",
                          "cpu", "--steps", "1"])


@pytest.mark.parametrize("arch", ARMS)
def test_launchers_serve_and_train_llava_text_only(arch):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    assert launch_serve.main(["--arch", arch, "--device", "cpu",
                              "--requests", "3", "--max-batch", "2",
                              "--max-len", "48", "--prompt-len", "12",
                              "--new-tokens", "3", "--prefill-chunk",
                              "8"]) == 0
    out = launch_train.run(["--arch", arch, "--device", "cpu", "--steps",
                            "3", "--batch", "2", "--seq", "16", "--lr",
                            "1e-3"])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
