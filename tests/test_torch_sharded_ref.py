"""The JAX reference side of the sharded-step tests (no test of its
own here): reduced configs' parameters drawn by the JAX package, their
batches, and ``jax.jit`` of the reference's single-device
``make_train_step``.

The port's sharded step runs in spawned gloo ranks
(``test_torch_dist_ranks.sharded_train``) from the same parameters (as
numpy, converted there by ``repro_torch.convert.params_from_jax``) and
the same batch.  Compared: every step's loss within 1e-5 of the
reference's (relative), every parameter after the last step within 1e-5
of the tree's scale (its largest |value|), the first AdamW moment within
1e-4 of its tree's scale.

AdamW runs at eps 1e-6 on both sides.  At the default 1e-8 the first
update of an element is lr·g / (|g| + 1e-8), whose size rests on g's
last digits where |g| is within a few 1e-8; the MoE family's key biases
have a gradient of 0 by analysis under Softmax (shift invariance), so
both packages return rounding there and the update is ±lr either way.
The update rule itself is held against the reference at the default eps
in tests/test_torch_train_optim.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_config
from repro.models.registry import get_model as jax_model
from repro.nn.module import unbox
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import init_adamw as jax_init_adamw
from repro.train.step import make_train_step as jax_make_train_step
from test_torch_dist_ranks import with_fields

OPT = dict(lr=1e-3, eps=1e-6)
LOSS_REL = 1e-5
PARAM_REL = 1e-5
MU_REL = 1e-4
#: tests/test_distributed.py's reduced dense config
DENSE = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=128,
             num_heads=4, num_kv_heads=2, head_dim=8)
B, S = 8, 16


def jax_cfg(arch, overrides, cfg_kw=None):
    return with_fields(jax_config(arch).reduced(**overrides), cfg_kw)


@functools.lru_cache(maxsize=None)
def jax_params(arch, overrides_items, cfg_kw_items=()):
    cfg = jax_cfg(arch, dict(overrides_items), dict(cfg_kw_items))
    p = unbox(jax.jit(jax_model(cfg).init)(jax.random.PRNGKey(0)))
    return jax.tree.map(np.asarray, p)


def make_batch(cfg, seed: int = 0, seq: int = S) -> dict:
    """B rows of ``seq`` tokens of the family's inputs.  The labels leave
    rows out unevenly (row 0 keeps one label, row 5 half), so each rank's
    count of valid labels differs; the vlm's image positions are ignored
    (-1)."""
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    if cfg.family == "encdec":
        batch = {"frames": rng.normal(size=(B, 12, cfg.frontend.embed_dim)
                                      ).astype(np.float32),
                 "tokens": rng.integers(0, v, (B, seq)).astype(np.int32)}
        labels = rng.integers(0, v, (B, seq)).astype(np.int32)
    elif cfg.family == "vlm":
        fe = cfg.frontend
        n_img = fe.tokens_per_item * fe.max_tiles
        batch = {"tokens": rng.integers(0, v, (B, seq)).astype(np.int32),
                 "image_embeds": rng.normal(size=(B, n_img, fe.embed_dim)
                                            ).astype(np.float32)}
        labels = np.concatenate(
            [np.full((B, n_img), -1, np.int32),
             rng.integers(0, v, (B, seq)).astype(np.int32)], axis=1)
    else:
        batch = {"tokens": rng.integers(0, v, (B, seq)).astype(np.int32)}
        labels = rng.integers(0, v, (B, seq)).astype(np.int32)
    labels[0, 1:] = -1
    labels[5, ::2] = -1
    batch["labels"] = labels
    return batch


def reference_run(arch, overrides, batch, steps, microbatches=1,
                  cfg_kw=None):
    """(losses, params, mu) of the reference's jitted single-device
    step."""
    cfg = jax_cfg(arch, overrides, cfg_kw)
    api = jax_model(cfg)
    opt = JaxAdamWConfig(**OPT)
    params = jax.tree.map(jnp.asarray, jax_params(
        arch, tuple(sorted(overrides.items())),
        tuple(sorted((cfg_kw or {}).items()))))
    state = jax_init_adamw(params, opt)
    step = jax.jit(jax_make_train_step(api, opt, microbatches))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(steps):
        params, state, m = step(params, state, jb)
        losses.append(float(m["loss"]))
    return losses, params, state.mu


def port_leaves(tree, cfg):
    """The reference's stacked tree split per layer and flattened in the
    port's leaf order (``convert.params_from_jax``'s layout)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.tree import tree_leaves

    return [t.numpy() for t in tree_leaves(params_from_jax(
        jax.tree.map(np.asarray, tree), cfg, device="cpu"))]


def assert_close_tree(got: list, want: list, rel: float, what: str):
    scale = max(float(np.abs(w).max()) for w in want)
    worst = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    assert worst <= rel * scale, (what, worst, scale)


def check_against_reference(rank0, arch, overrides, batch, steps,
                            microbatches=1, cfg_kw=None):
    from repro_torch.configs import get_config

    losses, params, mu = reference_run(arch, overrides, batch, steps,
                                       microbatches, cfg_kw)
    got = [m["loss"] for m in rank0["metrics"]]
    np.testing.assert_allclose(got, losses, rtol=LOSS_REL)
    cfg = with_fields(get_config(arch).reduced(**overrides), cfg_kw)
    assert_close_tree(rank0["params"], port_leaves(params, cfg), PARAM_REL,
                      "params")
    assert_close_tree(rank0["mu"], port_leaves(mu, cfg), MU_REL, "mu")
    assert rank0["step"] == steps
    return losses
