"""The port's sharding rules (repro_torch.distributed.sharding,
launch/shardings.py, the logical axes of ``ModelApi.axes()``) and the
small distributed helpers against the JAX package's, leaf for leaf.

  * ``api.axes()`` equals the reference's ``axes_of(eval_shape(init))``
    with each layer stack split and its ``"layers"`` axis dropped, for
    every arch id and paper-tiny at full width.
  * The rules tables; ``param_spec`` for every full-width config on
    (2, 2), (2, 2, 2), (16, 16) and (2, 16, 16) (the reference on
    ``jax.sharding.AbstractMesh``: no devices); ``batch_shardings``,
    ``opt_shardings`` and ``state_shardings`` at the decode_32k shape.
  * ``constrain``'s spec rule against the reference's
    ``with_sharding_constraint`` on a 16-device JAX CPU mesh (a
    subprocess), the 40-heads-on-16 fallback included; on a DTensor it
    redistributes, on a plain tensor it does nothing.
  * ``elastic_remesh_plan`` and ``bubble_fraction``; ``make_prefill_step``
    and ``make_serve_step`` against the reference's, and their sharded
    forms on gloo ranks against the single-device steps.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import test_torch_dist_ranks as torch_dist_ranks
from repro.configs import ARCH_IDS, SHAPES_BY_NAME
from repro.configs import get_config as jax_config
from repro.distributed import fault as jfault
from repro.distributed import pipeline as jpipe
from repro.distributed import sharding as jsh
from repro.launch import shardings as jshl
from repro.models.registry import get_model as jax_model
from repro.nn.module import axes_of, unbox
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import init_adamw as jax_init_adamw
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.distributed import fault as tfault
from repro_torch.distributed import pipeline as tpipe
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import shardings as tshl
from repro_torch.models.registry import get_model
from repro_torch.optim import AdamWConfig, init_adamw
from repro_torch.train import step as tstep
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(ARCH_IDS) + ["paper-tiny"]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _isax(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _norm(spec) -> tuple:
    parts = [tuple(p) if isinstance(p, (list, tuple)) else p for p in spec]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@functools.lru_cache(maxsize=None)
def _jax_boxed(arch):
    return jax.eval_shape(jax_model(jax_config(arch)).init,
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port(arch):
    api = get_model(get_config(arch))
    return api, api.init(torch.Generator(), device="meta")


def _stacks(arch):
    cfg = get_config(arch)
    return ({"blocks": cfg.num_layers} if cfg.encdec is None else
            {"encoder": cfg.encdec.encoder_layers,
             "decoder": cfg.encdec.decoder_layers})


def _ref_per_layer(arch, tree, fn):
    """The reference's tree with ``fn`` applied to each leaf of a layer
    stack (dropping its layer entry) and each stack listed per layer, in
    the port's layout."""
    stacks = _stacks(arch)
    out = {}
    for k, v in tree.items():
        if k in stacks:
            out[k] = [jax.tree.map(fn, v, is_leaf=_isax)] * stacks[k]
        else:
            out[k] = v
    return out


def _flat(tree):
    return [(p, x) for p, x in tree_flatten_with_path(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_equal_reference(arch):
    ref = _ref_per_layer(arch, axes_of(_jax_boxed(arch)), lambda a: a[1:])
    api, _ = _port(arch)
    # tuples are leaves here: compare the flattened (path, axes) lists
    flat = lambda t, pre=(): (  # noqa: E731
        [x for k in sorted(t) for x in flat(t[k], pre + (k,))]
        if isinstance(t, dict) else
        [x for i, e in enumerate(t) for x in flat(e, pre + (i,))]
        if isinstance(t, list) else [(pre, t)])
    assert flat(api.axes()) == flat(ref)


def test_rules_tables_equal_reference():
    assert tsh.PARAM_RULES == jsh.PARAM_RULES
    assert tsh.ACT_RULES == jsh.ACT_RULES


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_equals_reference(arch, mesh):
    shape, names = MESHES[mesh]
    jm, tm = AbstractMesh(shape, names), tsh.AbstractMesh(shape, names)
    boxed = _jax_boxed(arch)
    axes, struct = axes_of(boxed), unbox(boxed)
    ref = jax.tree.map(lambda a, s: jsh.param_spec(a, s.shape, jm), axes,
                       struct, is_leaf=_isax)
    ref = _ref_per_layer(arch, ref, lambda p: _norm(tuple(p)[1:]))
    api, params = _port(arch)
    got = [tsh.param_spec(a, tuple(p.shape), tm)
           for p, a in zip(tree_leaves(params),
                           _leaves_of_axes(api.axes()))]
    want = [_norm(tuple(x)) for _, x in _flat_specs(ref)]
    assert got == want
    # the port never shards unevenly
    sizes = dict(zip(names, shape))
    for p, spec in zip(tree_leaves(params), got):
        for n, part in zip(p.shape, spec):
            if part is not None:
                k = int(np.prod([sizes[a] for a in
                                 (part if isinstance(part, tuple)
                                  else (part,))]))
                assert n % k == 0


def _leaves_of_axes(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_of_axes(tree[k])]
    if isinstance(tree, list):
        return [x for e in tree for x in _leaves_of_axes(e)]
    return [tree]


def _flat_specs(tree, pre=()):
    from jax.sharding import PartitionSpec

    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_specs(tree[k],
                                                             pre + (k,))]
    if isinstance(tree, list):
        return [x for i, e in enumerate(tree)
                for x in _flat_specs(e, pre + (i,))]
    assert isinstance(tree, (tuple, PartitionSpec))
    return [(pre, tree)]


@pytest.mark.parametrize("mesh", ["2x2x2", "16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["smollm-135m", "hymba-1.5b", "rwkv6-7b",
                                  "seamless-m4t-large-v2",
                                  "llava-next-mistral-7b"])
def test_batch_opt_and_state_shardings_equal_reference(arch, mesh):
    shape, names = MESHES[mesh]
    jm, tm = AbstractMesh(shape, names), tsh.AbstractMesh(shape, names)
    dshape = SHAPES_BY_NAME["decode_32k"]
    tshape = SHAPES_BY_NAME["train_4k"]
    japi, (api, _) = jax_model(jax_config(arch)), _port(arch)
    jspecs = japi.input_specs(tshape)
    tspecs = api.input_specs(tshape)
    jb = jshl.batch_shardings(jspecs, jm)
    tb = tshl.batch_shardings(tspecs, tm)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert tb[k].spec == _norm(tuple(jb[k].spec)), k
    # opt: moments mirror the parameters, the step replicated
    small = {"w": jax.ShapeDtypeStruct((32, 16), jnp.float32)}
    jo = jshl.opt_shardings(jax.eval_shape(
        lambda p: jax_init_adamw(p, JaxAdamWConfig()), small),
        {"w": "PS"}, jm)
    to = tshl.opt_shardings(init_adamw({"w": torch.zeros(32, 16)},
                                       AdamWConfig()), {"w": "PS"}, tm)
    assert to.mu == jo.mu == {"w": "PS"} and to.nu == jo.nu
    assert to.step.spec == _norm(tuple(jo.step.spec)) == ()
    # decode states: the port's layer-shared cursor is () where the
    # reference's is (L,); both replicated
    b = dshape.global_batch
    js = jshl.state_shardings(jax.eval_shape(
        lambda: japi.init_states(b, dshape.seq_len)), jm)
    states = api.init_states(b, dshape.seq_len, device="meta")
    ts = tshl.state_shardings(states, tm, b)
    jflat = {jax.tree_util.keystr(p): s for p, s in
             jax.tree_util.tree_flatten_with_path(js)[0]}
    shardings = []
    tree_map(lambda st, sh: st is None or shardings.append(sh), states, ts)
    tflat = {"".join(p): sh for (p, _), sh in
             zip(tree_flatten_with_path(states), shardings)}
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        assert tflat[k].spec == _norm(tuple(jflat[k].spec)), k


# constrain: (shape, logical axes, mesh shape, mesh names)
CONSTRAIN_CASES = [
    ((8, 16, 32), ("batch", "seq_sp", "embed"), (2, 2, 2),
     ("pod", "data", "model")),
    ((8, 16, 64), ("batch", None, "vocab"), (2, 2, 2),
     ("pod", "data", "model")),
    ((4, 3, 5), ("expert", None, None), (2, 4), ("data", "model")),
    ((2, 40, 64, 8), ("batch", "heads", "seq_sp"), (1, 16),
     ("data", "model")),
    ((2, 48, 64, 8), ("batch", "heads", "seq_sp"), (1, 16),
     ("data", "model")),
    ((3, 8, 16), ("batch", "seq_sp", "embed"), (2, 4), ("data", "model")),
    ((16, 8), ("batch_heads", None), (2, 2, 4), ("pod", "data", "model")),
]


@pytest.fixture(scope="module")
def constrain_reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("constrain") / "specs.json"
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {os.path.join(ROOT, 'src')!r})
        import jax, jax.numpy as jnp
        from jax.sharding import AxisType
        from repro.distributed.sharding import constrain, use_mesh
        cases = {CONSTRAIN_CASES!r}
        specs = []
        for shape, axes, mshape, names in cases:
            n = 1
            for s in mshape:
                n *= s
            mesh = jax.make_mesh(mshape, names, devices=jax.devices()[:n],
                                 axis_types=(AxisType.Auto,) * len(names))
            with use_mesh(mesh):
                y = jax.jit(lambda x: constrain(x, *axes))(
                    jnp.zeros(shape, jnp.float32))
            specs.append([list(p) if isinstance(p, tuple) else p
                          for p in y.sharding.spec])
        json.dump(specs, open({str(out)!r}, "w"))
    """)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=16")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", range(len(CONSTRAIN_CASES)))
def test_constrain_spec_equals_reference(constrain_reference, case):
    shape, axes, mshape, names = CONSTRAIN_CASES[case]
    got = tsh.activation_spec(shape, axes, tsh.AbstractMesh(mshape, names))
    sizes = dict(zip(names, mshape))

    def layout(spec):
        # an axis of size 1 splits nothing (XLA drops it from the
        # output sharding it reports)
        parts = []
        for p in spec:
            p = tuple(a for a in ((p,) if isinstance(p, str) else p or ())
                      if sizes[a] > 1)
            parts.append(None if not p else p[0] if len(p) == 1 else p)
        return _norm(parts)

    assert layout(got) == layout(constrain_reference[case])
    if shape == (2, 40, 64, 8):
        assert got == ("data", None, "model")    # heads fall back to seq


def test_constrain_redistributes_a_dtensor_and_passes_plain_tensors(
        tmp_path):
    out = torch_dist_ranks.run_ranks(4, "constrain_dtensor", (), tmp_path)
    for r in out:
        assert r["y"] and r["z"]
        assert r["y_full_equal"] and r["plain_unchanged"]
    x = torch.zeros(2, 3)
    assert tsh.constrain(x, "batch") is x           # no mesh active


def test_elastic_remesh_plan_equals_reference():
    for chips in (1, 3, 7, 16, 100, 255, 256, 257, 511, 512, 1000, 4096):
        for mp in (1, 2, 4, 8, 16):
            for old in (1, 4, 16, 32):
                for per_pod in (64, 256):
                    kw = dict(model_parallelism=mp, old_data_parallelism=old,
                              chips_per_pod=per_pod)
                    try:
                        want = jfault.elastic_remesh_plan(chips, **kw)
                    except ValueError:
                        with pytest.raises(ValueError):
                            tfault.elastic_remesh_plan(chips, **kw)
                        continue
                    got = tfault.elastic_remesh_plan(chips, **kw)
                    assert (got.data, got.model, got.pods,
                            got.resliceable) == (want.data, want.model,
                                                 want.pods, want.resliceable)


def test_bubble_fraction_equals_reference():
    for s in range(1, 9):
        for m in range(1, 17):
            assert tpipe.bubble_fraction(s, m) == jpipe.bubble_fraction(s, m)


SMALL = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=128)


@functools.lru_cache(maxsize=None)
def _small():
    jcfg = jax_config("smollm-135m").reduced(**SMALL)
    jp = unbox(jax.jit(jax_model(jcfg).init)(jax.random.PRNGKey(0)))
    tcfg = get_config("smollm-135m").reduced(**SMALL)
    return jcfg, jp, tcfg, jax.tree.map(np.asarray, jp)


def test_prefill_and_serve_steps_equal_reference():
    jcfg, jp, tcfg, npp = _small()
    japi, api = jax_model(jcfg), get_model(tcfg)
    params = params_from_jax(npp, tcfg, device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 128, (8, 16)).astype(np.int32)
    want = jstep.make_prefill_step(japi)(jp, {"tokens": jnp.asarray(prompt)})
    got = tstep.make_prefill_step(api)(params, {"tokens": torch.from_numpy(
        prompt)})
    assert got.shape == (8, 1, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    tokens = rng.integers(0, 128, (8, 1)).astype(np.int32)
    jn, jl, js = jstep.make_serve_step(japi)(
        jp, jnp.asarray(tokens), japi.init_states(8, 16), None)
    tn, tl, ts = tstep.make_serve_step(api)(
        params, torch.from_numpy(tokens), api.init_states(8, 16,
                                                          device="cpu"))
    assert tn.dtype == torch.int32 and tn.shape == (8, 1)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ts.kv.k.numpy(), np.asarray(js.kv.k),
                               rtol=1e-5, atol=1e-6)
    assert int(ts.kv.length) == int(np.asarray(js.kv.length)[0]) == 1


def test_prefill_chunks_divisible_by_the_data_parallel_degree():
    """Under a mesh, chunks keep rows divisible by pod × data (the
    reference's rule): 8 rows over dp 4 -> 2 chunks of 4."""
    _, _, tcfg, npp = _small()
    api = get_model(tcfg)
    calls = []

    def counting(params, batch):
        calls.append(batch["tokens"].shape[0])
        return api.forward(params, batch)

    counted = api._replace(forward=counting)
    params = params_from_jax(npp, tcfg, device="cpu")
    batch = {"tokens": torch.zeros((8, 4), dtype=torch.int32)}
    with tsh.use_mesh(tsh.AbstractMesh((2, 2, 4), ("pod", "data", "model"))):
        tstep.make_prefill_step(counted)(params, batch)
    assert calls == [4, 4]
    calls.clear()
    tstep.make_prefill_step(counted)(params, batch)
    assert calls == [1] * 8


def test_sharded_prefill_and_serve_steps_equal_single_device(tmp_path):
    _, _, _, npp = _small()
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 128, (8, 16)).astype(np.int32)
    tokens = rng.integers(0, 128, (8, 1)).astype(np.int32)
    for r in torch_dist_ranks.run_ranks(
            4, "serving_steps", ((2, 2), ("data", "model"), "smollm-135m",
                                 SMALL, npp, tokens, prompt), tmp_path):
        for key in ("prefill", "logits"):
            want, got = r[key]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(r["next"][1], r["next"][0])
        assert r["length"] == 1
