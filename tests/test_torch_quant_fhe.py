"""The port's quantization and FHE stack against the JAX package's, on the
same parameters (the reference's init passed through ``params_from_jax``)
and the same numpy inputs: ``ptq_lm`` array for array and its refusals;
``lane_norm``, ``lane_mlp`` and ``lane_linear``; both lane attentions
(signed and unsigned, normalized, masked, GQA, a fully masked row,
test_lanes.py's large-key-count and high-``frac_bits`` cases); both
circuits; TFHE parameter selection and the cost model; fake-quant and its
straight-through gradient; the whole ``lm_forward_lane`` of paper-tiny
reduced (test_lanes.py's 2 layers, d 32) and at full width (seq 8) on
the int and fhe_sim lanes with their per-scope cost reports; the float
lane against the reference's float lane; the planner's ``int`` and
``fhe_sim`` backends; and ``python -m repro_torch.launch.fhe``.

Every model's wq and wk are scaled by 1/sqrt(head_dim) in both trees (as
tests/test_torch_model.py does): at the plain init every inhibition term
of paper-tiny is 0 and the inhibitor arm's attention drops out of the
logits.  Direct attention inputs take q, k in [-8, 8] and v in [-64, 64]
at d 16 and gamma_shift 2 for the same reason, and each such case asserts
that at least 10% of the reference's outputs are non-zero.

Tolerance: integer lanes, PTQ arrays and every cost count bit for bit;
float lanes within float32 rounding of the reference's float lane (rtol
1e-5, atol 1e-5 · max|ref|); fake-quant and its gradient within 1e-6.
"""

import functools
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fhe as jfhe
from repro.configs import get_config as jax_config
from repro.core import mechanism as jmech
from repro.core.lanes import get_lane as jget_lane
from repro.models import transformer as jtfm
from repro.models.registry import get_model as jax_model
from repro.nn import lane_layers as jll
from repro.nn.module import unbox
from repro.quant import int_attention as jia
from repro.quant import ptq as jptq
from repro_torch import fhe as tfhe
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import mechanism as tmech
from repro_torch.core.lanes import get_lane
from repro_torch.models import transformer as ttfm
from repro_torch.nn import lane_layers as tll
from repro_torch.quant import int_attention as tia
from repro_torch.quant import ptq as tptq

# the packages export the function ``fake_quant`` under the module's name
jfq = importlib.import_module("repro.quant.fake_quant")
tfq = importlib.import_module("repro_torch.quant.fake_quant")

ROOT = Path(__file__).resolve().parents[1]
REDUCED = dict(num_layers=2, d_model=32, d_ff=64, num_heads=2,
               num_kv_heads=2, head_dim=16)
MECHS = ("inhibitor", "inhibitor_unsigned", "dotprod")
MIN_NONZERO_SHARE = 0.1


def _lanes(name):
    return jget_lane(name), get_lane(name, device="cpu")


def _same(name, ref_lane, port_lane, ref_out, port_out):
    a, b = ref_lane.to_numpy(ref_out), port_lane.to_numpy(port_out)
    assert a.shape == b.shape
    if name == "float":
        np.testing.assert_allclose(
            b, a, rtol=1e-5, atol=1e-5 * max(float(np.abs(a).max()), 1.0))
    else:
        np.testing.assert_array_equal(b, a.astype(b.dtype))
    if name == "fhe_sim":
        assert port_lane.ctx.scope_report() == ref_lane.ctx.scope_report()
        assert port_lane.ctx.summary() == ref_lane.ctx.summary()
    return a


def _both(name, fn, *arrays):
    """``fn(lane, *handles)`` on the reference lane and the port's."""
    rl, pl = _lanes(name)
    with rl.scope("s"), pl.scope("s"):
        ro = fn(rl, *(rl.array(a) for a in arrays))
        po = fn(pl, *(pl.array(a) for a in arrays))
    return _same(name, rl, pl, ro, po), rl, pl


@functools.lru_cache(maxsize=None)
def _model(size):
    """(jax cfg, jax params, port cfg, port params) of paper-tiny, wq and
    wk scaled by 1/sqrt(head_dim)."""
    jcfg, tcfg = jax_config("paper-tiny"), get_config("paper-tiny")
    if size == "reduced":
        jcfg, tcfg = jcfg.reduced(**REDUCED), tcfg.reduced(**REDUCED)
    jp = unbox(jax_model(jcfg).init(jax.random.PRNGKey(0)))
    attn = dict(jp["blocks"]["attn"])
    for w in ("wq", "wk"):
        attn[w] = dict(attn[w], kernel=attn[w]["kernel"]
                       * jcfg.attention.head_dim ** -0.5)
    jp = dict(jp, blocks=dict(jp["blocks"], attn=attn))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@functools.lru_cache(maxsize=None)
def _qlms(size, mech):
    jcfg, jp, tcfg, tp = _model(size)
    return (jptq.ptq_lm(jp, jcfg.with_attention_kind(mech)),
            tptq.ptq_lm(tp, tcfg.with_attention_kind(mech)))


def _tokens(seq=8, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (1, seq))


# ---------------------------------------------------------------------------
# PTQ
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("mech", MECHS)
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_ptq_lm_matches_reference(size, mech):
    ref, port = _qlms(size, mech)
    for field in ("embed", "blocks", "final_norm", "lm_head"):
        rf, pf = _flat(getattr(ref, field)), _flat(getattr(port, field))
        assert rf.keys() == pf.keys()
        for k in rf:
            assert pf[k].dtype == np.int64, (field, k)
            np.testing.assert_array_equal(pf[k], rf[k], err_msg=field + k)
    assert port.ptq == tptq.PtqConfig(**vars(ref.ptq))
    for prop in ("gamma_shift", "alpha_q", "scale_shift"):
        assert getattr(port, prop) == getattr(ref, prop), prop


def _refusal_cfgs():
    import dataclasses

    return {
        "smollm-135m": (jax_config("smollm-135m"), get_config("smollm-135m")),
        "rwkv6-7b": (jax_config("rwkv6-7b"), get_config("rwkv6-7b")),
        "rope": tuple(dataclasses.replace(
            c, attention=dataclasses.replace(c.attention, use_rope=True))
            for c in (jax_config("paper-tiny"), get_config("paper-tiny"))),
        "tied": tuple(dataclasses.replace(c, tie_embeddings=True)
                      for c in (jax_config("paper-tiny"),
                                get_config("paper-tiny"))),
    }


@pytest.mark.parametrize("case", ["smollm-135m", "rwkv6-7b", "rope", "tied"])
def test_ptq_refuses_like_reference(case):
    jcfg, tcfg = _refusal_cfgs()[case]
    with pytest.raises(ValueError) as ref:
        jptq.ptq_lm({}, jcfg)
    with pytest.raises(ValueError) as port:
        tptq.ptq_lm({}, tcfg)
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# Lane layers
# ---------------------------------------------------------------------------

def _acts(rng, shape, ptq):
    return rng.integers(-ptq.act_clip, ptq.act_clip + 1, shape)


def _is_ref(lane) -> bool:
    return lane.__module__.startswith("repro.")


def _layers_of(lane):
    """(lane_layers module, PtqConfig) of the lane's package."""
    return ((jll, jptq.PtqConfig()) if _is_ref(lane)
            else (tll, tptq.PtqConfig()))


@pytest.mark.parametrize("name", ["int", "fhe_sim", "float"])
@pytest.mark.parametrize("subtract_mean", [False, True])
def test_lane_norm(rng, subtract_mean, name):
    ptq = tptq.PtqConfig()
    x = _acts(rng, (2, 5, 16), ptq)
    p = {"scale": np.round(rng.normal(1.0, 0.1, 16)
                           * (1 << ptq.weight_frac)).astype(np.int64),
         "bias": rng.integers(-8, 8, 16)}

    def fn(lane, t):
        mod, cfg = _layers_of(lane)
        return mod.lane_norm(lane, t, p, ptq=cfg, subtract_mean=subtract_mean)

    out, _, pl = _both(name, fn, x)
    assert np.mean(out != 0) > 0.5
    if name == "fhe_sim":
        assert pl.ctx.cmuls == 0


@pytest.mark.parametrize("name", ["int", "fhe_sim", "float"])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_lane_mlp(rng, activation, name):
    ptq = tptq.PtqConfig()
    x = _acts(rng, (1, 4, 8), ptq)
    wi = {"kernel": rng.integers(-40, 40, (8, 16)),
          "bias": rng.integers(-500, 500, 16)}
    wo = {"kernel": rng.integers(-40, 40, (16, 8))}

    def fn(lane, t):
        mod, cfg = _layers_of(lane)
        return mod.lane_mlp(lane, t, wi, wo, ptq=cfg, activation=activation)

    out, _, pl = _both(name, fn, x)
    assert np.mean(out != 0) > 0.5
    if name == "fhe_sim":
        s = pl.ctx.summary()
        assert s["cmuls"] == 0 and s["pbs"] == 16 * 4


@pytest.mark.parametrize("name", ["int", "fhe_sim", "float"])
def test_lane_linear(rng, name):
    x = _acts(rng, (3, 8), tptq.PtqConfig())
    p = {"kernel": rng.integers(-64, 64, (8, 5)),
         "bias": rng.integers(-100, 100, 5)}

    def fn(lane, t):
        mod, cfg = _layers_of(lane)
        return mod.lane_linear(lane, t, p, ptq=cfg)

    _both(name, fn, x)


def test_mean_literal_matches_reference():
    for d in (1, 16, 128, 255, 256, 512, 4096):
        assert tll._mean_literal(d) == jll._mean_literal(d)


# ---------------------------------------------------------------------------
# Lane attentions
# ---------------------------------------------------------------------------

def _causal(n_q, n_k):
    return np.tril(np.ones((n_q, n_k), bool))[None]


def _ragged_mask(rng, n_q, n_k):
    m = rng.random((1, n_q, n_k)) > 0.3
    m[0, 1, :] = False                     # a fully masked row
    return m


ATTN_CASES = {
    # name: (mechanism, shapes (q, k), value range, lane_fn kwargs, mask)
    "inh_signed": ("inh", (2, 7, 16), (2, 9, 16), 64,
                   dict(gamma_shift=2, signed=True), None),
    "inh_unsigned_normalized_causal": (
        "inh", (2, 9, 16), (2, 9, 16), 64,
        dict(gamma_shift=2, signed=False, normalize=True), "causal"),
    "inh_signed_normalized_masked_alpha": (
        "inh", (1, 6, 16), (1, 8, 16), 64,
        dict(gamma_shift=2, alpha_q=3, signed=True, normalize=True),
        "ragged"),
    "inh_large_key_count": ("inh", (1, 2, 8), (1, 300, 8), 31,
                            dict(gamma_shift=2, signed=True,
                                 normalize=True), None),
    "dot": ("dot", (2, 7, 16), (2, 9, 16), 64,
            dict(scale_shift=4, frac_bits=6), None),
    "dot_masked": ("dot", (1, 6, 16), (1, 8, 16), 64,
                   dict(scale_shift=4, frac_bits=8), "ragged"),
    "dot_causal_normalize": ("dot", (2, 9, 16), (2, 9, 16), 64,
                             dict(scale_shift=4, frac_bits=4,
                                  normalize=True), "causal"),
    "dot_high_frac_bits": ("dot", (1, 2, 8), (1, 600, 8), 127,
                           dict(scale_shift=8, frac_bits=12), None),
}


def _attn_inputs(rng, case):
    kind, qs, ks, vmax, kw, mask = ATTN_CASES[case]
    if case in ("inh_large_key_count", "dot_high_frac_bits"):
        q = rng.integers(-vmax, vmax + 1, qs)
        k = rng.integers(-vmax, vmax + 1, ks)
    else:
        q = rng.integers(-8, 9, qs)
        k = rng.integers(-8, 9, ks)
    v = rng.integers(-vmax, vmax + 1, ks)
    m = {None: None, "causal": lambda: _causal(qs[-2], ks[-2]),
         "ragged": lambda: _ragged_mask(rng, qs[-2], ks[-2])}[mask]
    return kind, q, k, v, kw, (m() if m else None)


@pytest.mark.parametrize("name", ["int", "fhe_sim", "float"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_lane_attention(rng, case, name):
    kind, q, k, v, kw, mask = _attn_inputs(rng, case)

    def fn(lane, qh, kh, vh):
        mod = jia if _is_ref(lane) else tia
        f = (mod.lane_inhibitor_attention if kind == "inh"
             else mod.lane_dot_product_attention)
        return f(lane, qh, kh, vh, mask=mask, **kw)

    out, _, pl = _both(name, fn, q, k, v)
    assert np.mean(out != 0) >= MIN_NONZERO_SHARE, np.mean(out != 0)
    if mask is not None and not mask[0, 1].any():
        assert np.all(out[:, 1] == 0)               # fully masked row
    if name == "fhe_sim":
        assert (pl.ctx.cmuls == 0) == (kind == "inh")


@pytest.mark.parametrize("name", ["int", "fhe_sim"])
@pytest.mark.parametrize("kind", ["inh", "dot"])
def test_lane_attention_heads_gqa(rng, kind, name):
    b, n, h, hk, d = 2, 6, 4, 2, 16
    q = rng.integers(-8, 9, (b, n, h, d))
    k = rng.integers(-8, 9, (b, n, hk, d))
    v = rng.integers(-64, 65, (b, n, hk, d))
    kw = (dict(gamma_shift=2, alpha_q=1, signed=True) if kind == "inh"
          else dict(scale_shift=4, frac_bits=6))
    mask = _causal(n, n)[None]

    def fn(lane, qh, kh, vh):
        mod = jia if _is_ref(lane) else tia
        f = (mod.lane_inhibitor_attention if kind == "inh"
             else mod.lane_dot_product_attention)
        return mod.lane_attention_heads(lane, f, qh, kh, vh, mask=mask, **kw)

    out, _, _ = _both(name, fn, q, k, v)
    assert np.mean(out != 0) >= MIN_NONZERO_SHARE


@pytest.mark.parametrize("kind", ["inh", "dot"])
def test_int_entry_points_and_frac_bits_refusal(rng, kind):
    q = rng.integers(-8, 9, (1, 5, 16))
    k = rng.integers(-8, 9, (1, 7, 16))
    v = rng.integers(-64, 65, (1, 7, 16))
    mask = _ragged_mask(rng, 5, 7)
    if kind == "inh":
        ref = jia.int_inhibitor_attention(
            jnp.asarray(q, jnp.int32), jnp.asarray(k, jnp.int32),
            jnp.asarray(v, jnp.int32), gamma_shift=2, alpha_q=1,
            signed=True, mask=jnp.asarray(mask))
        out = tia.int_inhibitor_attention(
            torch.from_numpy(q).int(), torch.from_numpy(k).int(),
            torch.from_numpy(v).int(), gamma_shift=2, alpha_q=1,
            signed=True, mask=torch.from_numpy(mask))
    else:
        ref = jia.int_dot_product_attention(
            jnp.asarray(q, jnp.int32), jnp.asarray(k, jnp.int32),
            jnp.asarray(v, jnp.int32), scale_shift=4,
            mask=jnp.asarray(mask))
        out = tia.int_dot_product_attention(
            torch.from_numpy(q).int(), torch.from_numpy(k).int(),
            torch.from_numpy(v).int(), scale_shift=4,
            mask=torch.from_numpy(mask))
        with pytest.raises(ValueError, match="frac_bits"):
            tia.int_dot_product_attention(out, out, out, frac_bits=13)
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert np.mean(np.asarray(ref) != 0) >= MIN_NONZERO_SHARE


def test_quantize_qkv_matches_reference(rng):
    q, k, v = (rng.normal(size=(5, 4)).astype(np.float32) for _ in range(3))
    ref = jia.quantize_qkv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    port = tia.quantize_qkv(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v))
    for r, p in zip(ref[:3], port[:3]):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    assert float(port[3]) == float(ref[3])


# ---------------------------------------------------------------------------
# Circuits, parameter selection, cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [2, 4, 8, 16])
@pytest.mark.parametrize("circuit", ["inhibitor", "inhibitor_unsigned",
                                     "dotprod"])
def test_circuits_match_reference(rng, circuit, T):
    q, k, v = (rng.integers(-7, 8, (T, 2)) for _ in range(3))
    if circuit == "dotprod":
        ref = jfhe.dotprod_attention_circuit(q, k, v, scale_shift=2)
        port = tfhe.dotprod_attention_circuit(
            q, k, v, scale_shift=2, ctx=tfhe.FheContext(device="cpu"))
    else:
        kw = dict(gamma_shift=1, alpha_q=1, signed=circuit == "inhibitor")
        ref = jfhe.inhibitor_attention_circuit(q, k, v, **kw)
        port = tfhe.inhibitor_attention_circuit(
            q, k, v, ctx=tfhe.FheContext(device="cpu"), **kw)
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1] == ref[1]
    assert (port[1]["cmuls"] == 0) == (circuit != "dotprod")
    assert tfhe.describe(port[1]) == jfhe.describe(ref[1])
    assert tfhe.circuit_seconds(port[1]) == jfhe.circuit_seconds(ref[1])


@pytest.mark.parametrize("bits", range(1, 18))
def test_select_params_and_pbs_seconds_match_reference(bits):
    if bits > 16:
        with pytest.raises(ValueError) as ref:
            jfhe.select_params(bits)
        with pytest.raises(ValueError) as port:
            tfhe.select_params(bits)
        assert str(port.value) == str(ref.value)
        return
    ref, port = jfhe.select_params(bits), tfhe.select_params(bits)
    assert vars(port) == vars(ref)
    assert tfhe.pbs_seconds(port) == jfhe.pbs_seconds(ref)


REPORTS = {
    "ok": ({"L0.attn": {"max_bits_at_pbs": 8}, "L0.mlp":
            {"max_bits_at_pbs": 11}}, None),
    "too_wide": ({"L0.attn": {"max_bits_at_pbs": 8},
                  "L3.mlp": {"max_bits_at_pbs": 17}}, None),
    "empty": ({}, None),
    "no_pbs": ({"L0.qkv_proj": {"max_bits_at_pbs": 0}}, None),
    "static_ok": ({"L0.attn": {"max_bits_at_pbs": 8}},
                  {"L0.attn": {"max_bits_at_pbs": 9}}),
    "static_unsound": ({"L0.attn": {"max_bits_at_pbs": 10}},
                       {"L0.attn": {"max_bits_at_pbs": 9}}),
    "static_missing": ({"L0.attn": {"max_bits_at_pbs": 8}}, {}),
}


@pytest.mark.parametrize("case", sorted(REPORTS))
def test_select_params_for_report_matches_reference(case):
    report, static = REPORTS[case]
    outs = []
    for mod in (jfhe, tfhe):
        try:
            outs.append(vars(mod.select_params_for_report(
                report, static_report=static)))
        except ValueError as e:
            outs.append(str(e))
        try:
            outs.append(vars(mod.select_params_static(static or report)))
        except ValueError as e:
            outs.append(str(e))
    assert outs[2:] == outs[:2]


# ---------------------------------------------------------------------------
# Fake quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("narrow_range", [False, True])
def test_fake_quant_and_straight_through_gradient(rng, per_channel,
                                                  narrow_range):
    x = rng.normal(size=(6, 32)).astype(np.float32)
    jcfg = jfq.QuantConfig(bits=8, per_channel=per_channel,
                           narrow_range=narrow_range)
    tcfg = tfq.QuantConfig(bits=8, per_channel=per_channel,
                           narrow_range=narrow_range)
    js = jfq.compute_scale(jnp.asarray(x), jcfg)
    ts = tfq.compute_scale(torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    jq = jfq.quantize(jnp.asarray(x), js, jcfg)
    tq = tfq.quantize(torch.from_numpy(x), ts, tcfg)
    assert tq.dtype == torch.int32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(tfq.dequantize(tq, ts).numpy(),
                               np.asarray(jfq.dequantize(jq, js)), atol=1e-6)
    jg = jax.grad(lambda t: (jfq.fake_quant(t, jcfg) ** 2).sum())(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tfq.fake_quant(xt, tcfg)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jfq.fake_quant(jnp.asarray(x),
                                                         jcfg)), atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), atol=1e-6)
    # straight through: the gradient of sum(fq(x)^2) is 2 fq(x)
    np.testing.assert_allclose(xt.grad.numpy(), 2 * y.detach().numpy(),
                               atol=1e-6)


def test_quantize_params_matches_reference(rng):
    tree = {"a": {"kernel": rng.normal(size=(4, 3)).astype(np.float32)},
            "b": rng.normal(size=(5,)).astype(np.float32),
            "n": np.arange(3, dtype=np.int32)}
    cfg = dict(bits=6)
    jq, js = jfq.quantize_params(jax.tree.map(jnp.asarray, tree),
                                 jfq.QuantConfig(**cfg))
    tq, ts = tfq.quantize_params(
        {"a": {"kernel": torch.from_numpy(tree["a"]["kernel"])},
         "b": torch.from_numpy(tree["b"]), "n": torch.from_numpy(tree["n"])},
        tfq.QuantConfig(**cfg))
    for path in (("a", "kernel"), ("b",), ("n",)):
        r, p, rs, ps = jq, tq, js, ts
        for key in path:
            r, p, rs, ps = r[key], p[key], rs[key], ps[key]
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
        np.testing.assert_allclose(ps.numpy(), np.asarray(rs), rtol=1e-7)


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane", ["int", "fhe_sim"])
@pytest.mark.parametrize("mech", MECHS)
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_model_lane_forward_bit_exact_with_reference(size, mech, lane):
    jq, tq = _qlms(size, mech)
    toks = _tokens()
    rl, pl = _lanes(lane)
    ref = rl.to_numpy(jtfm.lm_forward_lane(jq, rl, toks))
    out = pl.to_numpy(ttfm.lm_forward_lane(tq, pl, torch.from_numpy(toks)))
    np.testing.assert_array_equal(out, ref.astype(out.dtype))
    assert np.mean(ref != 0) >= MIN_NONZERO_SHARE
    if lane == "fhe_sim":
        report = pl.ctx.scope_report()
        assert report == rl.ctx.scope_report()
        assert list(report) == list(rl.ctx.scope_report())
        tot = pl.ctx.summary()
        assert tot == rl.ctx.summary()
        assert (tot["cmuls"] == 0) == mech.startswith("inhibitor")
        assert tot["pbs"] > 0
        assert vars(tfhe.select_params_for_report(report)) == vars(
            jfhe.select_params_for_report(rl.ctx.scope_report()))


@pytest.mark.parametrize("mech", MECHS)
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_model_float_lane_matches_reference_float_lane(size, mech):
    jq, tq = _qlms(size, mech)
    toks = _tokens()
    rl, pl = _lanes("float")
    ref = rl.to_numpy(jtfm.lm_forward_lane(jq, rl, toks))
    out = pl.to_numpy(ttfm.lm_forward_lane(tq, pl, toks))
    np.testing.assert_allclose(
        out, ref, rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("mech", MECHS)
def test_model_attention_is_live(mech):
    """Negating every wv changes the int lane's logits: attention reaches
    them (the parity above is not vacuous)."""
    import dataclasses

    _, tq = _qlms("full", mech)
    toks = _tokens()
    lane = get_lane("int", device="cpu")
    out = lane.to_numpy(ttfm.lm_forward_lane(tq, lane, toks))
    neg = dataclasses.replace(tq, blocks=[
        dict(b, wv={"kernel": -b["wv"]["kernel"]}) for b in tq.blocks])
    ctl = lane.to_numpy(ttfm.lm_forward_lane(neg, lane, toks))
    assert np.mean(ctl != out) > MIN_NONZERO_SHARE


# ---------------------------------------------------------------------------
# Planner backends
# ---------------------------------------------------------------------------

def _planner_inputs(rng, h, hk, d, n):
    q = rng.integers(-8, 9, (1, n, h, d))
    k = rng.integers(-8, 9, (1, n, hk, d))
    v = rng.integers(-64, 65, (1, n, hk, d))
    return q, k, v


def _execute(mod, mech, backend, causal, q, k, v, mask, params_kw):
    if mod is jmech:
        from repro.core.attention import AttentionConfig
        dtype, cast = jnp.int32, lambda a: jnp.asarray(a, jnp.int32)
        m = None if mask is None else jnp.asarray(mask)
        shapes = mod.AttnShapes(1, q.shape[1], k.shape[1], q.shape[2],
                                k.shape[2], q.shape[3], dtype=dtype)
    else:
        from repro_torch.core.attention import AttentionConfig
        dtype, cast = torch.int32, lambda a: torch.from_numpy(a).int()
        m = None if mask is None else torch.from_numpy(mask)
        shapes = mod.AttnShapes(1, q.shape[1], k.shape[1], q.shape[2],
                                k.shape[2], q.shape[3], dtype=dtype,
                                platform="cpu")
    cfg = AttentionConfig(mechanism=mech, backend=backend,
                          num_heads=q.shape[2], num_kv_heads=k.shape[2],
                          head_dim=q.shape[3], causal=causal)
    plan = mod.plan_attention(cfg, shapes)
    params = mod.get_mechanism(mech).make_params(**params_kw)
    out = mod.execute_plan(plan, cast(q), cast(k), cast(v), mask=m,
                           params=params)
    return plan, np.asarray(out)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("mech", MECHS)
def test_planner_int_backend_matches_reference(rng, mech, masked):
    n = 12
    q, k, v = _planner_inputs(rng, 6, 2, 16, n)
    mask = _causal(n, n)[None] if masked else None
    kw = dict(score_scale=None, score_shift=1.0, normalize=True)
    jplan, ref = _execute(jmech, mech, None, masked, q, k, v, mask, kw)
    tplan, out = _execute(tmech, mech, None, masked, q, k, v, mask, kw)
    assert tplan.backend == jplan.backend == "int"
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    assert np.mean(ref != 0) >= MIN_NONZERO_SHARE


@pytest.mark.parametrize("mech", MECHS)
def test_planner_fhe_sim_backend_matches_reference(rng, mech):
    q, k, v = _planner_inputs(rng, 2, 1, 8, 6)
    kw = dict(score_scale=None, score_shift=0.0, normalize=False)
    jplan, ref = _execute(jmech, mech, "fhe_sim", False, q, k, v, None, kw)
    tplan, out = _execute(tmech, mech, "fhe_sim", False, q, k, v, None, kw)
    assert tplan.backend == jplan.backend == "fhe_sim"
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    assert np.mean(ref != 0) >= MIN_NONZERO_SHARE
    with pytest.raises(ValueError, match="explicit masks"):
        _execute(tmech, mech, "fhe_sim", False, q, k, v,
                 np.ones((1, 1, 6, 6), bool), kw)


def test_no_backend_is_a_stub():
    for name in tmech.available_mechanisms():
        mech = tmech.get_mechanism(name)
        assert mech.lane_fn is not None and mech.fhe_circuit is not None
        assert mech.int_reference is not None
        for backend, fn in mech.backends.items():
            assert "_not_ported" not in getattr(fn, "__qualname__", ""), (
                name, backend)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_fhe_launcher_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fhe", "--device", "cpu"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("bit-exact with int lane") == 2
    assert "selected TFHE params" in proc.stdout
