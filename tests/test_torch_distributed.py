"""The port's collectives (repro_torch.distributed.collectives, .pipeline)
on 8 spawned gloo ranks, against the JAX package's on 8 CPU devices (a
subprocess: the device count is fixed before JAX starts) and against
numpy of the same formulas.

  * ``compressed_grad_sync`` on (2, 2, 2) ("pod", "data", "model"): with
    the same gradients on every rank (the reference's replicated input)
    bit for bit equal to the reference's output; with distinct per-rank
    gradients, bit for bit equal to numpy of the formula (the mean over
    ``data``, then over ``pod`` the max scale, the int8 payload summed as
    int32, × scale / pods).
  * ``allgather_matmul`` on an 8-way ``model`` axis against ``x @ w`` and
    the reference at rtol 1e-5.
  * ``pipeline_apply`` with 4 stages and 8 microbatches against the
    stages applied in sequence and the reference at 1e-5.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import test_torch_dist_ranks as torch_dist_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "same": {"a": np.arange(8.0, dtype=np.float32),
                 "b": rng.normal(size=(3, 5)).astype(np.float32)},
        "mine": {"a": rng.normal(size=(8, 40)).astype(np.float32),
                 "b": (rng.normal(size=(8, 3, 5)) * np.arange(1, 9)[:, None,
                                                              None]
                       ).astype(np.float32)},
        "x": rng.normal(size=(16, 64)).astype(np.float32),
        "w": rng.normal(size=(64, 32)).astype(np.float32),
        "ws": (rng.normal(size=(4, 16, 16)) * 0.5).astype(np.float32),
        "xs": rng.normal(size=(8, 2, 16)).astype(np.float32),
    }


def _reference(inp, tmp_path) -> dict:
    """The JAX package's three collectives on 8 CPU devices."""
    path = os.path.join(str(tmp_path), "in.npz")
    out = os.path.join(str(tmp_path), "ref.npz")
    np.savez(path, a=inp["same"]["a"], b=inp["same"]["b"], x=inp["x"],
             w=inp["w"], ws=inp["ws"], xs=inp["xs"])
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {os.path.join(ROOT, 'src')!r})
        import jax, jax.numpy as jnp, numpy as np
        assert len(jax.devices()) == 8, jax.devices()
        from repro.distributed.collectives import (allgather_matmul,
                                                   compressed_grad_sync)
        from repro.distributed.pipeline import pipeline_apply
        d = np.load({path!r})
        mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
        s = compressed_grad_sync({{"a": jnp.asarray(d["a"]),
                                   "b": jnp.asarray(d["b"])}}, mesh)
        y = allgather_matmul(jnp.asarray(d["x"]), jnp.asarray(d["w"]),
                             jax.make_mesh((8,), ("model",)))
        p = pipeline_apply(lambda w, x: jnp.tanh(x @ w),
                           jnp.asarray(d["ws"]), jnp.asarray(d["xs"]),
                           jax.make_mesh((4,), ("pipe",)),
                           num_microbatches=8)
        np.savez({out!r}, a=np.asarray(s["a"]), b=np.asarray(s["b"]),
                 y=np.asarray(y), p=np.asarray(p))
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    inp = _inputs()
    # rank r's gradient: the shared one ("same") on the reference's
    # replicated input, its own row of "mine" otherwise
    grads = {"same_a": np.broadcast_to(inp["same"]["a"], (8, 8)).copy(),
             "same_b": np.broadcast_to(inp["same"]["b"], (8, 3, 5)).copy(),
             "mine_a": inp["mine"]["a"], "mine_b": inp["mine"]["b"]}
    ranks = torch_dist_ranks.run_ranks(
        8, "collectives", (grads, inp["x"], inp["w"], inp["ws"], inp["xs"]),
        tmp)
    return inp, ranks, _reference(inp, tmp)


def _sync_numpy(g: np.ndarray) -> np.ndarray:
    """compressed_grad_sync's formula on (8, ...) per-rank gradients of a
    (2, 2, 2) mesh (rank = 4 pod + 2 data + model)."""
    g = g.reshape((2, 2, 2) + g.shape[1:]).astype(np.float32)
    gl = (g[:, 0] + g[:, 1]) / np.float32(2)              # (pod, model, ...)
    red = tuple(range(2, gl.ndim))
    scale = np.maximum(np.abs(gl).max(axis=red), np.float32(1e-12)) \
        / np.float32(127.0)                              # (pod, model)
    scale = scale.max(axis=0)                             # (model,)
    sc = scale.reshape((1, 2) + (1,) * (gl.ndim - 2))
    q = np.clip(np.round(gl / sc), -127, 127).astype(np.int8)
    s = q.astype(np.int32).sum(axis=0)                    # (model, ...)
    out = s.astype(np.float32) * (sc[0] / np.float32(2))
    return np.stack([out[m] for p in range(2) for d in range(2)
                     for m in range(2)])


def test_compressed_grad_sync_equals_reference_bit_for_bit(runs):
    _, ranks, ref = runs
    for r in ranks:
        np.testing.assert_array_equal(r["sync"]["same_a"], ref["a"])
        np.testing.assert_array_equal(r["sync"]["same_b"], ref["b"])
    # int8 rounding over a range of 7: within half a step of the input
    np.testing.assert_allclose(ref["a"], np.arange(8.0), atol=7 / 127 / 2)


@pytest.mark.parametrize("leaf", ["mine_a", "mine_b"])
def test_compressed_grad_sync_distinct_ranks_match_numpy(runs, leaf):
    inp, ranks, _ = runs
    want = _sync_numpy(inp["mine"][leaf[-1]])
    got = np.stack([r["sync"][leaf] for r in ranks])
    np.testing.assert_array_equal(got, want)
    # the payload changes something: the sync is not the identity
    assert not np.array_equal(got, inp["mine"][leaf[-1]])


def test_allgather_matmul_matches_matmul_and_reference(runs):
    inp, ranks, ref = runs
    y = np.concatenate([r["matmul"] for r in ranks], axis=1)
    np.testing.assert_allclose(y, inp["x"] @ inp["w"], rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(y, ref["y"], rtol=RTOL, atol=RTOL)


def test_pipeline_apply_matches_sequential_stages_and_reference(runs):
    inp, ranks, ref = runs
    seq = inp["xs"]
    for s in range(4):
        seq = np.tanh(seq @ inp["ws"][s])
    for r in ranks:                      # every rank returns the result
        np.testing.assert_allclose(r["pipeline"], seq, rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(r["pipeline"], ref["p"], rtol=RTOL,
                                   atol=RTOL)
