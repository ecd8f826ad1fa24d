"""The port's model (repro_torch.models) against the JAX package on
converted parameters: configs field by field, ``lm_step`` logits for both
mechanisms under contiguous, per-slot and paged decode states (the size
of conftest.py::serve_model), the paged decode state again with every
layer forced through the paged decode kernel's wrapper (its plain version
on the CPU) instead of the whole-model gather, the cache-free forward of
paper-tiny (LayerNorm, ReLU MLP, untied head, no RoPE), and the
conversion itself.

For the inhibitor, wq and wk are scaled in both trees so that q and k
have stddev 1/sqrt(head_dim): the score sum_d |q - k| / sqrt(d) - 0.5 is
then about 0.6 and the inhibition is materially nonzero.  At unit scale
it is about 4 at head_dim 16, every relu(v - Z) is 0, and attention
would drop out of the logits.

Tolerance: float32 on both sides through two layers; the fused inhibitor
form sums in another order than XLA's fusion, so logits (|logit| < 1)
agree to atol 5e-5, rtol 1e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as jtfm
from repro.models.registry import get_model as jax_model
from repro.nn.module import unbox
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import paged as kpaged
from repro_torch.models import transformer as ttfm
from repro_torch.models.registry import get_model

# full float32 matmuls and convolutions on a card (TF32 keeps ~3 digits)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=5e-5)
SMALL = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=128)


def _scale_qk(jp, factor):
    """Copy of the JAX parameter tree with every layer's wq and wk
    kernels times ``factor``."""
    attn = dict(jp["blocks"]["attn"])
    for w in ("wq", "wk"):
        attn[w] = dict(attn[w], kernel=attn[w]["kernel"] * factor)
    return dict(jp, blocks=dict(jp["blocks"], attn=attn))


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(jax cfg, jax api, jax params, port cfg, port api, port params)."""
    jcfg, tcfg = jax_config(arch), get_config(arch)
    if arch.startswith("smollm"):
        jcfg, tcfg = jcfg.reduced(**SMALL), tcfg.reduced(**SMALL)
    japi = jax_model(jcfg)
    jp = unbox(jax.jit(japi.init)(jax.random.PRNGKey(0)))
    if jcfg.attention.mechanism.startswith("inhibitor"):
        jp = _scale_qk(jp, jcfg.attention.head_dim ** -0.5)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    # jitted reference entry points: one compile per signature instead of
    # op-by-op dispatch
    japi = japi._replace(step=jax.jit(japi.step),
                         forward=jax.jit(japi.forward))
    return jcfg, japi, jp, tcfg, get_model(tcfg), tp


@pytest.mark.parametrize("arch", ["smollm-135m", "smollm-135m@inhibitor",
                                  "paper-tiny"])
def test_config_fields_match_reference(arch):
    ref, port = jax_config(arch), get_config(arch)
    for f in dataclasses.fields(port):
        if f.name != "attention":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (dataclasses.asdict(port.attention)
            == dataclasses.asdict(ref.attention))
    assert str(port.cdtype).replace("torch.", "") == str(ref.cdtype)
    red_ref, red_port = ref.reduced(**SMALL), port.reduced(**SMALL)
    assert (red_port.num_layers, red_port.d_model, red_port.compute_dtype,
            red_port.attention.num_heads, red_port.remat) == (
        red_ref.num_layers, red_ref.d_model, red_ref.compute_dtype,
        red_ref.attention.num_heads, red_ref.remat)


def test_conversion_splits_layers_and_init_matches_shapes():
    jcfg, _, jp, tcfg, tapi, tp = _models("smollm-135m")
    assert len(tp["blocks"]) == jcfg.num_layers
    np.testing.assert_array_equal(
        tp["blocks"][1]["attn"]["wq"]["kernel"].numpy(),
        np.asarray(jp["blocks"]["attn"]["wq"]["kernel"][1]))
    fresh = tapi.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape[1:]), jp["blocks"])
    got = jax.tree.map(lambda t: tuple(t.shape), fresh["blocks"][0])
    assert got == shapes
    assert fresh["embed"]["table"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["smollm-135m", "smollm-135m@inhibitor"])
@pytest.mark.parametrize("layout", ["contiguous", "per_slot", "paged",
                                    "paged_kernel"])
def test_lm_step_logits_match_reference(arch, layout):
    """Prefill 7 tokens then decode 2, batch 2; paged rows own
    non-contiguous pages (page 8).  ``paged_kernel`` forces the decode
    steps onto ``paged_pallas``: each layer writes its row into its pool
    in place and calls the kernel wrapper on the cursors; the JAX side
    takes its default paged step."""
    jcfg, japi, jp, tcfg, tapi, tp = _models(arch)
    paged = layout.startswith("paged")
    kw = (dict(paged=True, page_size=8) if paged
          else dict(per_slot=True) if layout == "per_slot" else {})
    js = jtfm.init_states(jcfg, 2, 32, **kw)
    ts = ttfm.init_states(tcfg, 2, 32, device="cpu", **kw)
    if paged:
        tab = np.asarray([[3, 1, 5, 0], [2, 4, 6, 7]], np.int32)
        js = js._replace(kv=js.kv._replace(block_tables=jnp.broadcast_to(
            jnp.asarray(tab)[None], js.kv.block_tables.shape)))
        ts.kv.block_tables.copy_(torch.from_numpy(tab))
    decode_cfg = tcfg
    if layout == "paged_kernel":
        decode_cfg = dataclasses.replace(tcfg, attention=dataclasses.replace(
            tcfg.attention, backend="paged_pallas"))
    toks = np.random.default_rng(0).integers(0, 128, (2, 9)).astype(np.int32)
    kpaged.reset_counts()
    for lo, hi in ((0, 7), (7, 8), (8, 9)):
        jl, js = japi.step(jp, jnp.asarray(toks[:, lo:hi]), js, None)
        tl, ts = ttfm.lm_step(tp, decode_cfg if hi - lo == 1 else tcfg,
                              torch.from_numpy(toks[:, lo:hi]), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert ts.kv.length.tolist() == ([9, 9] if layout != "contiguous"
                                     else 9)
    plain = ("paged_inhibitor_plain" if arch.endswith("@inhibitor")
             else "paged_attention_plain")
    assert kpaged.counts()[plain] == (2 * tcfg.num_layers
                                      if layout == "paged_kernel" else 0)


def test_paper_tiny_forward_matches_reference():
    jcfg, japi, jp, tcfg, tapi, tp = _models("paper-tiny")
    toks = np.random.default_rng(1).integers(0, 256, (2, 12)).astype(
        np.int32)
    jl, _ = japi.forward(jp, {"tokens": jnp.asarray(toks)})
    tl = tapi.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_paged_states_own_per_layer_storage():
    """In-place cache writes need real per-layer storage: layer 0's write
    must not appear in layer 1 (a broadcast view would alias them)."""
    _, _, _, tcfg, tapi, tp = _models("smollm-135m")
    st = ttfm.init_states(tcfg, 1, 16, paged=True, page_size=8,
                          device="cpu")
    st.kv.block_tables[0, :2] = torch.tensor([1, 2])
    _, st = tapi.step(tp, torch.tensor([[5, 6, 7]]), st)
    k = st.kv.k
    assert k.stride(0) == k[0].numel()
    assert not torch.equal(k[0, 1, :3], k[1, 1, :3])
    assert not k[:, 0].any()           # nothing landed on the trash page
