"""Checkpoints under a mesh: the port's ``train()`` on 4 spawned gloo
ranks at (2, 2) ("data", "model"), reduced smollm-135m (dot-product),
async commits every 2 steps (keep 2): 6 steps uninterrupted, then the
same run cut at 4 and resumed to 6.

Held: the resumed run's losses, parameters and AdamW moments equal the
uninterrupted run's bit for bit on every rank's shards, with a fresh
placement's DTensor placements; rank 0 alone wrote, and the root holds
committed ``step_*`` directories only; the commit is a one-process
commit (its ``meta.json`` equals that of the gathered state saved by one
process), restores in one process without a mesh, and restores through
the reference's ``repro.checkpoint.store.restore`` (float32 leaves),
each equal to the gathered parameters and moments.  Under ``torchrun``
with 2 gloo ranks, ``launch.train --data-parallel 2 --ckpt-dir D``
for 4 steps and then for 6 resumes at step 4 with the one-process
run's losses.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dist_ranks as torch_dist_ranks
import test_torch_sharded_ref as ref
from repro.checkpoint import store as jstore
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro_torch.checkpoint import committed_steps, restore, save
from repro_torch.configs import get_config
from repro_torch.models.registry import get_model
from repro_torch.optim import AdamWConfig
from repro_torch.train.step import init_train_state
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

MESH = ((2, 2), ("data", "model"))
STEPS, CUT, EVERY = 6, 4, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           OMP_NUM_THREADS="1")

_RUN = {}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results and the checkpoint root, spawned once."""
    if not _RUN:
        root = tmp_path_factory.mktemp("ckpt_mesh")
        _RUN["ranks"] = torch_dist_ranks.run_ranks(
            4, "ckpt_resume", (*MESH, ref.DENSE, str(root), STEPS, CUT,
                               EVERY), root)
        _RUN["root"] = root
    return _RUN["ranks"], _RUN["root"]


def _like():
    """A state of the reduced config's structure, on the CPU."""
    api = get_model(get_config("smollm-135m").reduced(**ref.DENSE))
    return init_train_state(api, AdamWConfig(lr=1e-3), torch.Generator(),
                            device="cpu")


def test_resumed_run_equals_the_uninterrupted_one(run):
    ranks, _ = run
    losses = ranks[0]["losses"]
    assert len(losses["full"]) == STEPS and ranks[0]["start"] == CUT
    assert losses["first"] == losses["full"][:CUT]
    assert losses["resumed"] == losses["full"][CUT:]
    for r in ranks:
        assert all(r["shards_equal"]), r["shards_equal"]


def test_resumed_state_has_a_fresh_placement(run):
    ranks, _ = run
    for r in ranks:
        p = r["placements"]
        assert p["resumed"] == p["full"] == p["fresh"]
        assert all(kind == "DTensor" and grad
                   for kind, grad in r["resumed_params"])
    # some leaves are sharded over both axes, some replicated on one
    full = ranks[0]["placements"]["full"]
    assert any(p.count("Shard") == 2 for p in full)
    assert any("Replicate" in p for p in full)


def test_only_rank_zero_writes_committed_directories(run):
    ranks, root = run
    assert ranks[0]["saves"] == {"full": [2, 4, 6], "cut": [2, 4, 6]}
    assert all(r["saves"] == {} for r in ranks[1:])
    for sub in ("full", "cut"):
        d = root / sub
        assert sorted(os.listdir(d)) == ["step_00000004", "step_00000006"]
        assert committed_steps(str(d)) == [4, 6]
        for s in os.listdir(d):
            assert "COMMITTED" in os.listdir(d / s)


def test_mesh_commit_is_a_one_process_commit(run, tmp_path):
    """The gathered state written by one process gives the same
    meta.json (names, keys, shards, dtypes, shapes, step) and the same
    arrays as the commit rank 0 wrote under the mesh."""
    ranks, root = run
    like = _like()
    gathered = tree_unflatten(like, [torch.from_numpy(a)
                                     for a in ranks[0]["gathered"]])
    save(str(tmp_path), STEPS, gathered)
    metas = [json.loads((d / f"step_{STEPS:08d}" / "meta.json").read_text())
             for d in (root / "full", tmp_path)]
    assert metas[0] == metas[1]
    names = [e["name"] for e in metas[0]["leaves"]]
    assert "0/blocks/1/attn/wq/kernel" in names and "1/.step" in names


def test_mesh_commit_restores_in_one_process(run):
    ranks, root = run
    got, step = restore(str(root / "full"), _like(), device="cpu")
    assert step == STEPS
    leaves = tree_leaves(got)
    assert len(leaves) == len(ranks[0]["gathered"])
    for a, b in zip(leaves, ranks[0]["gathered"]):
        assert not hasattr(a, "placements")
        np.testing.assert_array_equal(a.numpy(), b)
    assert int(got[1].step) == STEPS


def test_mesh_commit_restores_through_the_reference_store(run):
    """The reference's store reads the commit by leaf names into a tree of
    the port's structure in the reference's containers (its own AdamW
    state); every leaf is float32 but the int32 step."""
    ranks, root = run
    params, state = tree_map(lambda t: jnp.asarray(t.detach().numpy()),
                             _like())
    theirs = (params, JaxAdamWState(step=state.step, mu=state.mu,
                                    nu=state.nu))
    back, step = jstore.restore(str(root / "full"), theirs)
    assert step == STEPS and isinstance(back[1], JaxAdamWState)
    have = jax.tree.leaves((back[0], back[1].step, back[1].mu, back[1].nu))
    assert len(have) == len(ranks[0]["gathered"])
    for a, b in zip(have, ranks[0]["gathered"]):
        assert a.dtype == b.dtype and a.dtype in (jnp.float32, jnp.int32)
        np.testing.assert_array_equal(np.asarray(a), b)


def _summary(stdout: str) -> dict:
    return json.loads([ln for ln in stdout.splitlines()
                       if ln.startswith("{")][-1])


def test_torchrun_trains_and_resumes_with_ckpt_dir(tmp_path):
    args = ["-m", "repro_torch.launch.train", "--device", "cpu",
            "--batch", "8", "--seq", "32"]
    one = subprocess.run([sys.executable, *args, "--steps", "6"], cwd=ROOT,
                         env=ENV, capture_output=True, text=True,
                         timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    dist = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", *args, "--data-parallel", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    runs = []
    for steps in ("4", "6"):
        r = subprocess.run(dist + ["--steps", steps], cwd=ROOT, env=ENV,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        runs.append(_summary(r.stdout))
    want = _summary(one.stdout)["losses"]
    first, again = runs
    assert first["start_step"] == 0 and again["start_step"] == 4
    assert again["mesh"] == [2, 1] and len(again["losses"]) == 2
    np.testing.assert_allclose(first["losses"], want[:4], rtol=1e-5)
    np.testing.assert_allclose(again["losses"], want[4:], rtol=1e-5)
    assert committed_steps(str(tmp_path)) == [2, 4, 6]
