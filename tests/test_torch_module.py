"""repro_torch.nn.module against repro.nn.module: the Param box and its
rank check, box / unbox / axes round trips over ``ModelApi.axes()``,
parameter counts and bytes on every reduced config, ``cast_params``, and
``fold_key``'s process invariance."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.nn import module as jmod
from repro_torch.configs import get_config
from repro_torch.models.registry import get_model
from repro_torch.nn import module as tmod
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(ARCH_IDS) + ["paper-tiny"]


def test_param_rank_check_matches_reference():
    with pytest.raises(ValueError, match="rank mismatch"):
        tmod.Param(torch.zeros(2, 3), ("embed",))
    with pytest.raises(ValueError, match="rank mismatch"):
        jmod.Param(jnp.zeros((2, 3)), ("embed",))
    p = tmod.Param(torch.zeros(2, 3), ["vocab", "embed"])
    assert p.axes == ("vocab", "embed") and p.shape == (2, 3)
    assert p.dtype == torch.float32 and tmod.is_param(p)
    assert not tmod.is_param(torch.zeros(1))


def test_box_unbox_axes_round_trip():
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device="cpu")
    axes = api.axes()
    boxed = tmod.box_like(params, axes)
    assert all(tmod.is_param(b) for b in tree_leaves(boxed))
    assert all(a is b for a, b in zip(tree_leaves(tmod.unbox(boxed)),
                                      tree_leaves(params)))
    flat = lambda t: [x for x in tree_leaves(t)]  # noqa: E731
    assert flat(tmod.axes_of(boxed)) == flat(axes)
    # maps keep the annotations
    doubled = tmod.tree_map_params(lambda x: x * 2, boxed)
    assert tmod.axes_of(doubled) == tmod.axes_of(boxed)
    text = tmod.format_tree(boxed, max_leaves=3)
    assert "blocks/0/attn/wk/bias" in text and "(+" in text


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_bytes_equal_reference(arch):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    boxed = jax.eval_shape(jax_model(jcfg).init, jax.random.PRNGKey(0))
    api = get_model(tcfg)
    params = api.init(torch.Generator().manual_seed(0), device="meta")
    boxed_t = tmod.box_like(params, api.axes())
    assert tmod.param_count(boxed_t) == jmod.param_count(boxed)
    assert tmod.param_count(params) == jmod.param_count(boxed)
    assert tmod.param_bytes(boxed_t) == jmod.param_bytes(boxed)


def test_cast_params_leaves_integer_leaves_alone():
    tree = {"w": tmod.Param(torch.ones(2, 2), ("embed", "mlp")),
            "ids": torch.arange(3, dtype=torch.int32),
            "b": torch.zeros(2)}
    out = tmod.cast_params(tree, torch.bfloat16)
    assert out["w"].value.dtype == torch.bfloat16
    assert out["w"].axes == ("embed", "mlp")
    assert out["b"].dtype == torch.bfloat16
    assert out["ids"].dtype == torch.int32
    assert torch.equal(out["ids"], tree["ids"])
    jtree = {"ids": jnp.arange(3, dtype=jnp.int32)}
    assert jmod.cast_params(jtree, jnp.bfloat16)["ids"].dtype == jnp.int32


def _draw(hashseed: str) -> str:
    code = ("import sys; sys.path.insert(0, 'src'); import torch; "
            "from repro_torch.nn.module import KeyGen, fold_key, split_keys; "
            "g = torch.Generator().manual_seed(7); kg = KeyGen(g); "
            "a = torch.randn(4, generator=fold_key(g, 'wq')); "
            "b = torch.randn(4, generator=kg('wk')); "
            "c = torch.randn(4, generator=split_keys(g, 3)[2]); "
            "print(torch.cat([a, b, c]).tolist())")
    env = dict(os.environ, PYTHONHASHSEED=hashseed)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_fold_key_is_process_invariant():
    a, b = _draw("1"), _draw("12345")
    assert a == b
    g = torch.Generator().manual_seed(7)
    # names and seeds give different streams; the parent's state is not
    # consumed
    x = torch.randn(4, generator=tmod.fold_key(g, "wq"))
    y = torch.randn(4, generator=tmod.fold_key(g, "wk"))
    z = torch.randn(4, generator=tmod.fold_key(
        torch.Generator().manual_seed(8), "wq"))
    assert not torch.equal(x, y) and not torch.equal(x, z)
    assert torch.equal(torch.randn(2, generator=g),
                       torch.randn(2, generator=torch.Generator()
                                   .manual_seed(7)))
