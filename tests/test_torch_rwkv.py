"""The port's RWKV-6 family (repro_torch.nn.ssm, kernels.rwkv6, kernels.ops.
wkv6, models.rwkv) against the JAX package on the same numpy inputs and
converted parameters.

* ``wkv6_chunked_plain`` (the CUDA kernel's plain version) against the
  reference's chunked kernel in interpret mode and against its exact scan,
  over the reference's sweep (tests/test_kernels.py) and at zero decay:
  outputs and final state within rtol = atol = 1e-3 of the scan (the
  reference's own tolerance), and within 2e-5 of the largest magnitude of
  the interpret kernel (the same chunked arithmetic, summed in another
  order: the largest difference seen is 7e-6 of it).
* The reduced model's logits (2 layers, d 64, 4 heads, lora 8) through
  both WKV paths of the port against the reference's forward.  At init
  u, mu_base, the mixing LoRAs' B and the decay LoRA's B are zero and the
  decay sits at exp(-exp(-6)); the test draws every one of them (and the
  channel-mix mixes) from a numpy seed first, so every term is live, and
  zeroing u in the port alone moves the logits beyond the tolerance.
* Decode against forward (``lm_step`` over 5 tokens, then 1) at 2e-3, as
  tests/test_archs_smoke.py does for the reference: the state-carrying
  branch of ``ops.wkv6``.
* Gradients: ``ops.wkv6`` (plain forward, the chunk-by-chunk backward)
  against ``jax.grad`` of the reference's exact scan, and one reduced
  train step's loss and every parameter's gradient against ``jax.grad`` of
  the reference's loss (which takes the exact scan on the CPU), through
  the port's scan and through its kernel path, to 1e-4 relative (the norm
  of the difference over the norm), as for the dense family.  The decay
  of the gradient test is exp(-exp(N(0, 1))), inside the kernel's floor:
  below 1e-30 the kernel's floored log is constant, so its gradient in w
  is 0 there while the scan's is not (tested on its own).
* Config and planner: ``@inhibitor`` is rejected; ``reduced()`` and
  ``with_layers()`` equal the reference's field by field; the WKV plan is
  ``naive`` for CPU tokens and ``pallas`` where the kernel is native.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.data.pipeline import lm_batch_at as jax_lm_batch_at
from repro.kernels import ref as jref
from repro.kernels.rwkv6 import wkv6_chunked as jax_wkv6_chunked
from repro.models.registry import get_model as jax_model
from repro.nn.module import unbox
from repro.train.step import make_loss_fn as jax_make_loss_fn
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.mechanism import choose_plan, kernel_native
from repro_torch.data.pipeline import PipelineConfig, lm_batch_at
from repro_torch.kernels import ops as kops
from repro_torch.kernels import rwkv6 as krwkv6
from repro_torch.models import rwkv as trwkv
from repro_torch.models.registry import get_model
from repro_torch.train.step import make_grad_fn
from repro_torch.tree import tree_leaves

SWEEP = [(50, 3, 16, 16), (32, 2, 8, 8), (17, 1, 16, 32)]
SCAN_TOL = dict(rtol=1e-3, atol=1e-3)
KERNEL_REL = 2e-5
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
REL = 1e-4


def _wkv_inputs(seed, b, t, h, n, decay_std=2.0):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return rng.normal(size=shape).astype(np.float32)

    r, k, v = mk(b, t, h, n), mk(b, t, h, n), mk(b, t, h, n)
    w = np.exp(-np.exp(rng.normal(size=(b, t, h, n)) * decay_std)).astype(
        np.float32)
    return r, k, v, w, mk(h, n)


def _plain(r, k, v, w, u, chunk):
    out, state = krwkv6.wkv6_chunked_plain(
        *map(torch.from_numpy, (r, k, v, w, u)), chunk=chunk)
    return out.numpy(), state.numpy()


def _within(got, ref, rel):
    err = np.abs(got - ref).max()
    assert err <= rel * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("t,heads,n,chunk", SWEEP)
def test_plain_matches_interpret_kernel_and_scan(t, heads, n, chunk):
    r, k, v, w, u = _wkv_inputs(0, 2, t, heads, n)
    jin = [jnp.asarray(x) for x in (r, k, v, w, u)]
    o_k, s_k = map(np.asarray, jax_wkv6_chunked(*jin, chunk=chunk,
                                                interpret=True))
    o_r, s_r = map(np.asarray, jref.wkv6_ref(*jin))
    o, s = _plain(r, k, v, w, u, chunk)
    np.testing.assert_allclose(o, o_r, **SCAN_TOL)
    np.testing.assert_allclose(s, s_r, **SCAN_TOL)
    _within(o, o_k, KERNEL_REL)
    _within(s, s_k, KERNEL_REL)
    # live controls: no bonus, and V one step late, both land far outside
    for ctl in (_plain(r, k, v, w, 0 * u, chunk)[0],
                _plain(r, k, np.roll(v, 1, axis=1), w, u, chunk)[0]):
        assert np.abs(ctl - o_r).max() > 100 * SCAN_TOL["atol"]


def test_plain_zero_decay_is_finite_and_matches():
    """w = 0 (the hardest case): the 1e-30 floor keeps every log finite,
    and the result is the scan's (whose state keeps no history)."""
    r, k, v, _, u = _wkv_inputs(1, 1, 24, 1, 8)
    w = np.zeros_like(r)
    jin = [jnp.asarray(x) for x in (r, k, v, w, u)]
    o_k, s_k = map(np.asarray, jax_wkv6_chunked(*jin, chunk=8,
                                                interpret=True))
    o_r, s_r = map(np.asarray, jref.wkv6_ref(*jin))
    o, s = _plain(r, k, v, w, u, 8)
    assert np.isfinite(o).all() and np.isfinite(s).all()
    np.testing.assert_allclose(o, o_r, **SCAN_TOL)
    np.testing.assert_allclose(s, s_r, **SCAN_TOL)
    _within(o, o_k, KERNEL_REL)
    _within(s, s_k, KERNEL_REL)


def test_wrapper_takes_the_plain_version_on_cpu_and_checks_shapes():
    r, k, v, w, u = map(torch.from_numpy, _wkv_inputs(2, 1, 5, 2, 8))
    kops.reset_counts()
    out, state = krwkv6.wkv6_chunked(r, k, v, w, u)
    assert out.shape == (1, 5, 2, 8) and state.shape == (1, 2, 8, 8)
    assert kops.counts()["wkv6_plain"] == 1 and kops.counts()["wkv6"] == 0
    with pytest.raises(ValueError, match="heads, head_dim"):
        krwkv6.wkv6_chunked(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="chunk"):
        krwkv6.wkv6_chunked(r, k, v, w, u, chunk=65)


# ---------------------------------------------------------------------------
# gradients of ops.wkv6
# ---------------------------------------------------------------------------

def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("t,chunk", [(50, 16), (32, 32), (7, 32)])
def test_wkv6_gradients_match_jax_grad_of_the_scan(t, chunk):
    b, h, n = 2, 3, 16
    r, k, v, w, u = _wkv_inputs(3, b, t, h, n, decay_std=1.0)
    rng = np.random.default_rng(4)
    g_out = rng.normal(size=(b, t, h, n)).astype(np.float32)
    g_state = rng.normal(size=(b, h, n, n)).astype(np.float32)

    def jloss(*xs):
        out, state = jref.wkv6_ref(*xs)
        return jnp.sum(out * g_out) + jnp.sum(state * g_state)

    ref = jax.grad(jloss, argnums=range(5))(
        *[jnp.asarray(x) for x in (r, k, v, w, u)])
    leaves = [torch.from_numpy(x).requires_grad_() for x in (r, k, v, w, u)]
    kops.reset_counts()
    out, state = kops.wkv6(*leaves, chunk=chunk)
    loss = (out * torch.from_numpy(g_out)).sum() + (
        state * torch.from_numpy(g_state)).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, a, e in zip("rkvwu", got, ref):
        assert np.abs(np.asarray(e)).max() > 1e-3, name
        assert _rel(a.numpy(), e) <= REL, name
    # the forward took the plain version once; the backward never does
    assert kops.counts()["wkv6_plain"] == 1


def test_wkv6_gradient_of_w_below_the_floor_is_zero():
    r, k, v, w, u = (torch.from_numpy(x)
                     for x in _wkv_inputs(5, 1, 9, 1, 8, decay_std=1.0))
    w[0, 3, 0, :4] = 0.0
    leaves = [x.requires_grad_() for x in (r, k, v, w, u)]
    out, _ = kops.wkv6(*leaves, chunk=4)
    gw = torch.autograd.grad(out.sum(), leaves[3])[0]
    assert not gw[0, 3, 0, :4].any() and gw[0, 3, 0, 4:].abs().min() > 0


def test_wkv6_with_a_carried_state_takes_the_scan():
    r, k, v, w, u = map(torch.from_numpy, _wkv_inputs(6, 1, 6, 2, 8))
    s0 = torch.from_numpy(np.random.default_rng(7).normal(
        size=(1, 2, 8, 8)).astype(np.float32))
    kops.reset_counts()
    out, state = kops.wkv6(r, k, v, w, u, s0)
    o_r, s_r = jref.wkv6_ref(*[jnp.asarray(x.numpy())
                               for x in (r, k, v, w, u, s0)])
    np.testing.assert_allclose(out.numpy(), np.asarray(o_r), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(s_r), rtol=1e-5,
                               atol=1e-5)
    assert kops.counts()["wkv6_plain"] == 0


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _live(jp, seed=0):
    """The reference tree with every RWKV term that init leaves zero (or
    constant) drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    blocks = jax.tree.map(np.asarray, jp["blocks"])
    tm, cm = dict(blocks["time_mix"]), dict(blocks["channel_mix"])

    def draw(a, loc, scale):
        return (loc + scale * rng.normal(size=a.shape)).astype(np.float32)

    tm["u"] = draw(tm["u"], 0.0, 0.5)
    tm["mu_base"] = rng.uniform(size=tm["mu_base"].shape).astype(np.float32)
    tm["mix_lora_b"] = draw(tm["mix_lora_b"], 0.0, 0.3)
    tm["mix_lora_a"] = draw(tm["mix_lora_a"], 0.0, 0.3)
    tm["w_lora_b"] = draw(tm["w_lora_b"], 0.0, 0.3)
    tm["w_lora_a"] = draw(tm["w_lora_a"], 0.0, 0.3)
    tm["w_base"] = draw(tm["w_base"], -1.0, 1.0)
    tm["ln_x"] = {"scale": draw(tm["ln_x"]["scale"], 1.0, 0.2),
                  "bias": draw(tm["ln_x"]["bias"], 0.0, 0.2)}
    cm["mu_k"] = rng.uniform(size=cm["mu_k"].shape).astype(np.float32)
    cm["mu_r"] = rng.uniform(size=cm["mu_r"].shape).astype(np.float32)
    blocks = dict(blocks, time_mix=tm, channel_mix=cm)
    return dict(jax.tree.map(np.asarray, jp), blocks=blocks)


@functools.lru_cache(maxsize=None)
def _models():
    """(jax cfg, jax api, live jax params, port cfg, port api, port
    params)."""
    jcfg = jax_config("rwkv6-7b").reduced()
    tcfg = get_config("rwkv6-7b").reduced()
    japi = jax_model(jcfg)
    jp = _live(unbox(jax.jit(japi.init)(jax.random.PRNGKey(0))))
    tp = params_from_jax(jp, tcfg, device="cpu")
    return jcfg, japi, jax.tree.map(jnp.asarray, jp), tcfg, get_model(tcfg), tp


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_conversion_carries_the_rwkv_tree():
    jcfg, _, jp, tcfg, tapi, tp = _models()
    tm = tp["blocks"][1]["time_mix"]
    np.testing.assert_array_equal(
        tm["mix_lora_b"].numpy(),
        np.asarray(jp["blocks"]["time_mix"]["mix_lora_b"][1]))
    assert tuple(tm["mu_base"].shape) == (5, tcfg.d_model)
    assert set(tm["ln_x"]) == {"scale", "bias"}
    fresh = tapi.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape[1:]), jp["blocks"])
    assert jax.tree.map(lambda x: tuple(x.shape),
                        fresh["blocks"][0]) == shapes
    assert sorted(fresh) == sorted(jp)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_match_reference(use_kernel):
    """Batch 2 x 45 tokens (a chunk of 32 and a tail of 13 on the kernel
    path)."""
    jcfg, japi, jp, tcfg, tapi, tp = _models()
    toks = _tokens(0, 2, 45, tcfg.vocab_size)
    jl, _ = jax.jit(japi.forward)(jp, {"tokens": jnp.asarray(toks)})
    jl = np.asarray(jl)
    kops.reset_counts()
    tl = trwkv.lm_forward(tp, tcfg, torch.from_numpy(toks),
                          use_kernel=use_kernel).numpy()
    np.testing.assert_allclose(tl, jl, **MODEL_TOL)
    assert kops.counts()["wkv6_plain"] == (tcfg.num_layers if use_kernel
                                           else 0)
    # control: the bonus u zeroed in the port alone moves the logits
    ctl = [dict(b, time_mix=dict(b["time_mix"],
                                 u=torch.zeros_like(b["time_mix"]["u"])))
           for b in tp["blocks"]]
    cl = trwkv.lm_forward(dict(tp, blocks=ctl), tcfg,
                          torch.from_numpy(toks), use_kernel=use_kernel)
    assert np.abs(cl.numpy() - jl).max() > 10 * (
        MODEL_TOL["atol"] + MODEL_TOL["rtol"] * np.abs(jl).max())


def test_decode_matches_forward():
    _, _, _, tcfg, tapi, tp = _models()
    toks = torch.from_numpy(_tokens(1, 2, 8, tcfg.vocab_size))
    full = tapi.forward(tp, {"tokens": toks})
    states = tapi.init_states(2, 16, device="cpu")
    lg1, states = tapi.step(tp, toks[:, :5], states)
    lg2, states = tapi.step(tp, toks[:, 5:6], states)
    np.testing.assert_allclose(lg1.numpy(), full[:, :5].numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(lg2.numpy(), full[:, 5:6].numpy(), rtol=2e-3,
                               atol=2e-3)
    assert states.wkv.shape == (tcfg.num_layers, 2, 4, 16, 16)


@functools.lru_cache(maxsize=None)
def _jax_grads():
    jcfg, japi, jp, tcfg, _, _ = _models()
    pipe = dict(global_batch=2, seq_len=40, vocab_size=tcfg.vocab_size,
                seed=0)
    jbatch = {k: jnp.asarray(v) for k, v in jax_lm_batch_at(
        JaxPipelineConfig(**pipe), 0).items()}
    loss_fn = jax_make_loss_fn(japi)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jp, jbatch)
    tbatch = {k: torch.from_numpy(v) for k, v in lm_batch_at(
        PipelineConfig(**pipe), 0).items()}
    return float(loss), jax.tree.map(np.asarray, grads), tbatch


@pytest.mark.parametrize("use_kernel", [False, True])
def test_train_step_loss_and_gradients_match_jax_grad(use_kernel):
    """One reduced train step (batch 2 x 40 of ``lm_batch_at``): the loss
    and every parameter's gradient.  ``use_kernel`` routes the WKV through
    ``ops.wkv6`` (the kernel's plain version on the CPU, the chunk-by-chunk
    backward), else the port's exact scan, as its registry does on the
    CPU."""
    _, _, _, tcfg, tapi, tp = _models()
    jloss, jgrads, batch = _jax_grads()
    if use_kernel:
        tapi = tapi._replace(forward=lambda p, b: trwkv.lm_forward(
            p, tcfg, b["tokens"], use_kernel=True))
    params = params_from_jax(jax.tree.map(np.asarray, _models()[2]), tcfg,
                             device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    kops.reset_counts()
    grads, metrics = make_grad_fn(tapi)(params, batch)
    assert abs(float(metrics["loss"]) - jloss) <= REL * abs(jloss)
    assert kops.counts()["wkv6_plain"] == (tcfg.num_layers if use_kernel
                                           else 0)
    ref = params_from_jax(jgrads, tcfg, device="cpu")
    n = 0
    for got, want in zip(tree_leaves(grads), tree_leaves(ref)):
        assert float(want.abs().max()) > 0.0
        assert _rel(got.numpy(), want.numpy()) <= REL
        n += 1
    assert n == len(tree_leaves(tp))
    u_grad = grads["blocks"][0]["time_mix"]["u"]
    assert float(u_grad.abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# config and planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["inhibitor", "inhibitor_unsigned"])
def test_rwkv_rejects_the_inhibitor(kind):
    with pytest.raises(ValueError):
        get_config(f"rwkv6-7b@{kind}")
    assert get_config("rwkv6-7b@dotprod").attention.mechanism == "dotprod"


@pytest.mark.parametrize("variant", ["full", "reduced", "with_layers"])
def test_config_fields_match_reference(variant):
    ref, port = jax_config("rwkv6-7b"), get_config("rwkv6-7b")
    if variant == "reduced":
        ref, port = ref.reduced(), port.reduced()
    elif variant == "with_layers":
        ref, port = ref.with_layers(4), port.with_layers(4)
    for f in dataclasses.fields(port):
        if f.name in ("attention", "ssm"):
            assert (dataclasses.asdict(getattr(port, f.name))
                    == dataclasses.asdict(getattr(ref, f.name))), f.name
        else:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert str(port.cdtype).replace("torch.", "") == str(ref.cdtype)


def test_wkv_plan_is_naive_on_cpu_and_pallas_where_the_kernel_is_native():
    assert kernel_native("wkv6", "cuda") and not kernel_native("wkv6", "cpu")

    def plan(platform, carried=False):
        return trwkv.wkv_plan(kernel_native("wkv6", platform), carried)

    assert plan("cpu").backend == "naive"
    assert plan("cuda").backend == "pallas"
    assert plan("cuda", carried=True).backend == "naive"
    # the registry's forward on CPU tokens takes the scan, not the kernel
    _, _, _, tcfg, tapi, tp = _models()
    kops.reset_counts()
    tapi.forward(tp, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    assert kops.counts()["wkv6_plain"] == 0
    with pytest.raises(ValueError, match="no eligible"):
        choose_plan("wkv6", [("pallas", False, "")])


def test_train_launcher_cuts_the_depth_and_trains_rwkv_on_the_cpu():
    from repro_torch.launch import train as launch_train

    out = launch_train.run(["--device", "cpu", "--arch", "rwkv6-7b",
                            "--layers", "1", "--steps", "3", "--batch", "2",
                            "--seq", "16", "--seed", "0"])
    assert out["layers"] == 1 and out["device"] == "cpu"
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert launch_train.run(["--device", "cpu", "--arch", "rwkv6-7b",
                             "--steps", "1", "--batch", "1", "--seq",
                             "8"])["layers"] == jax_config(
                                 "rwkv6-7b").reduced().num_layers
