"""The port's checkpoint store and manager, resume through ``train()`` and
the launchers, and the background ``Prefetcher`` — on the CPU, at a
reduced size.

The resume test mirrors tests/test_train_loop.py::
test_checkpoint_resume_exact: a run that stops at step 12 and resumes
from its step-10 commit ends with the parameters (and here also the
optimizer state) of an uninterrupted run, within that test's rtol 1e-5 /
atol 1e-6.  Everything else is exact: a restored leaf equals the saved
one bit for bit, dtype included.

Against the reference (:mod:`repro.checkpoint.store`, :mod:`repro.train.
loop`): the same tree written by both stores gives the same inventory and
the same arrays, and each store restores the other's commit; a port run
started from the reference's step-0 commit, cut at 12 and resumed, has
the reference's losses within tests/test_torch_train_step.py's
port-against-reference 1e-4.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointConfig as JaxCheckpointConfig
from repro.checkpoint import store as jstore
from repro.configs import get_config as jax_config
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.data.pipeline import lm_batch_at as jax_lm_batch_at
from repro.models.registry import get_model as jax_model
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import train as jax_train
from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                    committed_steps, latest_step, restore,
                                    retain, save)
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import PipelineConfig, Prefetcher, lm_batch_at
from repro_torch.models.registry import get_model
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.loop import TrainConfig, train
from repro_torch.tree import tree_flatten_with_path, tree_leaves


def _tree():
    g = torch.Generator().manual_seed(0)
    params = {"blocks": [{"w": torch.randn(3, 4, generator=g),
                          "b": torch.randn(4, generator=g)}
                         for _ in range(2)],
              "embed": torch.randn(5, 4, generator=g).to(torch.bfloat16),
              "table": np.arange(6, dtype=np.int64).reshape(2, 3)}
    opt = AdamWState(step=torch.tensor(7, dtype=torch.int32),
                     mu={"m": torch.randn(2, generator=g)},
                     nu={"m": torch.rand(2, generator=g)})
    return (params, opt, None)


def _assert_same(a, b):
    pa, pb = tree_flatten_with_path(a), tree_flatten_with_path(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        x = torch.as_tensor(x)
        assert x.dtype == y.dtype, path
        assert torch.equal(x, y), path


@pytest.mark.parametrize("shard_bytes", [None, 16])
def test_store_round_trip(tmp_path, monkeypatch, shard_bytes):
    """Nested dicts and lists, a NamedTuple with an int32 step, bfloat16
    and numpy leaves and a None subtree come back as they went in, one
    shard or many."""
    if shard_bytes is not None:
        monkeypatch.setattr(store, "_SHARD_BYTES", shard_bytes)
    tree = _tree()
    path = save(str(tmp_path), 3, tree, extra={"note": "x"})
    assert os.path.basename(path) == "step_00000003"
    files = sorted(os.listdir(path))
    assert files[0] == "COMMITTED" and "meta.json" in files
    n_shards = sum(f.startswith("shard_") for f in files)
    # at 16 bytes a shard: each of the six parameter leaves fills one,
    # the optimizer's step and two 2-float moments share the seventh
    assert n_shards == (1 if shard_bytes is None else 7)
    meta = json.loads((tmp_path / "step_00000003" / "meta.json").read_text())
    assert meta["step"] == 3 and meta["extra"] == {"note": "x"}
    names = [e["name"] for e in meta["leaves"]]
    # named as the reference names them: a NamedTuple field is ".field"
    assert "1/.step" in names and "1/.mu/m" in names
    assert "0/blocks/1/w" in names
    assert {e["name"]: e["dtype"] for e in meta["leaves"]}[
        "0/embed"] == "bfloat16"

    out, step = restore(str(tmp_path), tree, device="cpu")
    assert step == 3
    assert isinstance(out[1], AdamWState) and out[2] is None
    assert out[1].step.dtype == torch.int32 and int(out[1].step) == 7
    assert all(x.device.type == "cpu" for x in tree_leaves(out[:2]))
    _assert_same(tree, out)
    # a sub-structure reads its own leaves only: the parameters alone
    (params, none), _ = restore(str(tmp_path), (tree[0], None), device="cpu")
    assert none is None
    _assert_same(tree[0], params)


def test_restore_refuses_missing_and_misshapen_leaves(tmp_path):
    tree = _tree()
    save(str(tmp_path), 1, tree)
    with pytest.raises(KeyError, match="missing leaves"):
        restore(str(tmp_path), {"other": torch.zeros(1)}, device="cpu")
    bad = ({**tree[0], "embed": torch.zeros(4, 5)}, None)
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path), bad, device="cpu")
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "empty"), tree, device="cpu")


def test_restore_defaults_to_the_card(tmp_path):
    save(str(tmp_path), 1, {"x": torch.ones(2)})
    if torch.cuda.is_available():
        out, _ = restore(str(tmp_path), {"x": torch.ones(2)})
        assert out["x"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            restore(str(tmp_path), {"x": torch.ones(2)})


def test_uncommitted_directories_are_ignored(tmp_path):
    tree = {"x": torch.arange(3.0)}
    save(str(tmp_path), 4, tree)
    # a crash mid-save: the staging directory and a directory without
    # the marker are not restore points
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000008")
    (tmp_path / "step_00000008" / "meta.json").write_text("{}")
    os.makedirs(tmp_path / "step_notanumber")
    (tmp_path / "step_notanumber" / "COMMITTED").write_text("ok")
    assert committed_steps(str(tmp_path)) == [4]
    assert latest_step(str(tmp_path)) == 4
    assert restore(str(tmp_path), tree, device="cpu")[1] == 4
    assert committed_steps(str(tmp_path / "absent")) == []
    assert latest_step(str(tmp_path / "absent")) is None


@pytest.mark.parametrize("keep", [0, 1, 2, 5])
def test_retain_keeps_the_newest(tmp_path, keep):
    for s in (1, 5, 3, 10):
        save(str(tmp_path), s, {"x": torch.tensor(float(s))})
    retain(str(tmp_path), keep)
    want = [1, 3, 5, 10] if keep == 0 else [1, 3, 5, 10][-keep:]
    assert committed_steps(str(tmp_path)) == want


def test_async_snapshot_is_isolated_from_in_place_updates(tmp_path,
                                                          monkeypatch):
    """The optimizer updates in place: an async save must write the
    state as it was when ``save`` was called, even when the next step
    overwrites the live tensors before the writer runs."""
    go = threading.Event()
    real_save = store.save

    def slow_save(*a, **k):
        go.wait(timeout=10)
        return real_save(*a, **k)

    monkeypatch.setattr(store, "save", slow_save)
    params = {"w": torch.arange(4.0), "step": torch.tensor(1,
                                                           dtype=torch.int32)}
    want = {k: v.clone() for k, v in params.items()}
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), every_steps=2,
                                             async_save=True))
    assert not mgr.maybe_save(1, params)
    assert mgr.maybe_save(2, params)
    with torch.no_grad():                     # the next step, in place
        params["w"].mul_(-3.0)
        params["step"].add_(1)
    go.set()
    mgr.wait()
    out, step = mgr.restore(params, device="cpu")
    assert step == 2
    _assert_same(want, out)


def test_manager_surfaces_write_errors_and_restores_or_inits(tmp_path,
                                                             monkeypatch):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), keep=2))

    def init():
        return {"x": torch.zeros(2)}

    tree, start = mgr.restore_or_init(init, device="cpu")
    assert start == 0 and torch.equal(tree["x"], torch.zeros(2))
    mgr.save(5, {"x": torch.ones(2)})
    mgr.wait()
    tree, start = mgr.restore_or_init(init, device="cpu")
    assert start == 5 and torch.equal(tree["x"], torch.ones(2))

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(store, "save", broken)
    mgr.save(6, {"x": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    sync = CheckpointManager(CheckpointConfig(str(tmp_path),
                                              async_save=False))
    with pytest.raises(OSError, match="disk full"):
        sync.save(7, {"x": torch.ones(2)})
    assert mgr.latest_step() == 5


def test_prefetcher_order_and_close():
    seen = []

    def batch_fn(step):
        seen.append(step)
        return {"tokens": np.full((2,), step)}

    pf = Prefetcher(batch_fn, start_step=3, depth=2)
    got = [next(pf) for _ in range(5)]
    assert [s for s, _ in got] == [3, 4, 5, 6, 7]
    assert all(int(b["tokens"][0]) == s for s, b in got)
    assert iter(pf) is pf
    pf.close()
    assert not pf._thread.is_alive()
    # each batch is made once, in order
    assert seen == list(range(3, 3 + len(seen)))

    def failing(step):
        if step == 1:
            raise ValueError("bad batch")
        return step

    pf = Prefetcher(failing)
    assert next(pf) == (0, 0)
    with pytest.raises(ValueError, match="bad batch"):
        next(pf)
    pf.close()


# ---------------------------------------------------------------------------
# Resume through train() and the launchers
# ---------------------------------------------------------------------------

def _setup(vocab=128):
    """tests/test_train_loop.py's reduced smollm-135m and LM stream."""
    cfg = get_config("smollm-135m").reduced(num_layers=2, d_model=48,
                                            d_ff=96, vocab_size=vocab,
                                            num_heads=4, num_kv_heads=2,
                                            head_dim=12)
    api = get_model(cfg)
    pipe = PipelineConfig(global_batch=8, seq_len=32, vocab_size=vocab,
                          seed=11)
    return api, (lambda step: lm_batch_at(pipe, step))


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_resume_exact(tmp_path, async_save):
    """Crash at step 12, resume from the step-10 commit -> the final
    params and optimizer state of an uninterrupted run."""
    api, batch_fn = _setup()
    opt = AdamWConfig(lr=1e-3)

    full = train(api, opt, TrainConfig(total_steps=20), batch_fn,
                 device="cpu")

    ck = CheckpointConfig(str(tmp_path), every_steps=10,
                          async_save=async_save)
    first = train(api, opt, TrainConfig(total_steps=12, checkpoint=ck),
                  batch_fn, device="cpu")
    assert [h["step"] for h in first["history"]] == list(range(12))
    assert committed_steps(str(tmp_path)) == [10, 12]
    # the crash: the step-12 commit is lost, step 10 is the newest
    retain(str(tmp_path), 2)
    import shutil
    shutil.rmtree(tmp_path / "step_00000012")
    resumed = train(api, opt, TrainConfig(total_steps=20, checkpoint=ck),
                    batch_fn, device="cpu")
    assert [h["step"] for h in resumed["history"]] == list(range(10, 20))
    assert committed_steps(str(tmp_path)) == [10, 20]
    assert all(p.requires_grad and p.is_leaf
               for p in tree_leaves(resumed["params"]))
    for a, b in zip(tree_leaves((full["params"], full["opt_state"])),
                    tree_leaves((resumed["params"], resumed["opt_state"]))):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    assert int(resumed["opt_state"].step) == 20
    # the losses after the resume are the uninterrupted run's
    np.testing.assert_allclose(
        [h["loss"] for h in resumed["history"]],
        [h["loss"] for h in full["history"][10:]], rtol=1e-5, atol=1e-6)


def test_launch_train_resumes_from_ckpt_dir(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    base = ["--device", "cpu", "--steps", "6", "--batch", "4", "--seq",
            "16", "--seed", "0"]
    assert launch_train.main(base) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ck = str(tmp_path)
    assert launch_train.main(base + ["--ckpt-dir", ck, "--ckpt-every",
                                     "3"]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["start_step"] == 0 and committed_steps(ck) == [3, 6]
    # lose the last commit: the rerun resumes from step 3
    import shutil
    shutil.rmtree(os.path.join(ck, "step_00000006"))
    assert launch_train.main(base + ["--ckpt-dir", ck, "--ckpt-every",
                                     "3"]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["start_step"] == 3 and len(again["losses"]) == 3
    np.testing.assert_allclose(again["losses"], ref["losses"][3:],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(first["losses"], ref["losses"], rtol=1e-5,
                               atol=1e-6)


def test_launch_serve_loads_ckpt_dir(tmp_path, monkeypatch):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.serve import engine as engine_mod

    ck = str(tmp_path)
    assert launch_train.main(["--device", "cpu", "--steps", "2", "--batch",
                              "2", "--seq", "16", "--seed", "3",
                              "--ckpt-dir", ck]) == 0
    served = {}
    real_init = engine_mod.Engine.__init__

    def spy(self, api, params, *a, **k):
        served["params"] = params
        return real_init(self, api, params, *a, **k)

    monkeypatch.setattr(engine_mod.Engine, "__init__", spy)
    argv = ["--device", "cpu", "--requests", "2", "--new-tokens", "2",
            "--max-len", "64", "--prompt-len", "8", "--max-batch", "2"]
    assert launch_serve.main(argv + ["--ckpt-dir", ck]) == 0
    saved, step = restore(ck, (served["params"], None), device="cpu")
    assert step == 2
    _assert_same(saved[0], served["params"])
    assert not any(p.requires_grad for p in tree_leaves(served["params"]))
    # without the flag the engine serves the seeded init, which differs
    assert launch_serve.main(argv) == 0
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(served["params"]), tree_leaves(saved[0])))


def test_train_inhibitor_lm_entry(tmp_path, capsys):
    from repro_torch.launch import train_inhibitor_lm

    ck = str(tmp_path / "ck")
    assert train_inhibitor_lm.main(["--steps", "2", "--device", "cpu",
                                    "--ckpt-dir", ck]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "smollm-135m@inhibitor"
    assert out["batch"] == 16 and out["seq"] == 256
    assert committed_steps(ck) == [2]
    assert train_inhibitor_lm.DEFAULT_CKPT_DIR.parts[-2:] == (
        "build", "train_inhibitor_lm")


# ---------------------------------------------------------------------------
# Against the reference's store and train()
# ---------------------------------------------------------------------------

def _tree_pair(bf16=True):
    """One tree in each package's containers, from one numpy seed: nested
    dicts and lists, each package's AdamW state with its int32 step, a
    None subtree and (where ``bf16``) a bfloat16 leaf whose values
    bfloat16 holds exactly."""
    rng = np.random.default_rng(5)
    w = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(2)]
    b = [rng.standard_normal(4).astype(np.float32) for _ in range(2)]
    mu = rng.standard_normal(2).astype(np.float32)
    nu = rng.random(2).astype(np.float32)
    emb = (rng.integers(-16, 16, (5, 4)) / 4.0).astype(np.float32)

    def build(arr, bfloat16, state):
        params = {"blocks": [{"w": arr(w[i]), "b": arr(b[i])}
                             for i in range(2)],
                  "head": {"table": arr(np.arange(6, dtype=np.int32)
                                        .reshape(2, 3))}}
        if bf16:
            params["embed"] = bfloat16(emb)
        opt = state(step=arr(np.array(7, np.int32)), mu={"m": arr(mu)},
                    nu={"m": arr(nu)})
        return (params, opt, None)

    ours = build(torch.from_numpy, lambda a: torch.from_numpy(a).to(
        torch.bfloat16), AdamWState)
    theirs = build(jnp.asarray, lambda a: jnp.asarray(a, jnp.bfloat16),
                   JaxAdamWState)
    return ours, theirs


@pytest.mark.parametrize("shard_bytes", [None, 16])
def test_store_inventory_matches_reference(tmp_path, monkeypatch,
                                           shard_bytes):
    """The same tree through both stores: equal meta.json (names, keys,
    shards, dtypes, shapes, step, extra) and equal arrays, byte for
    byte, bfloat16 included."""
    if shard_bytes is not None:
        monkeypatch.setattr(store, "_SHARD_BYTES", shard_bytes)
        monkeypatch.setattr(jstore, "_SHARD_BYTES", shard_bytes)
    ours, theirs = _tree_pair()
    save(str(tmp_path / "port"), 4, ours, extra={"note": "x"})
    jstore.save(str(tmp_path / "ref"), 4, theirs, extra={"note": "x"})
    metas, arrays = [], []
    for side in ("port", "ref"):
        d = tmp_path / side / "step_00000004"
        assert sorted(os.listdir(d)) == sorted(
            os.listdir(tmp_path / "ref" / "step_00000004"))
        meta = json.loads((d / "meta.json").read_text())
        metas.append(meta)
        got = {}
        for e in meta["leaves"]:
            with np.load(d / f"shard_{e['shard']:05d}.npz") as z:
                a = z[e["key"]]
                got[e["name"]] = (a.dtype.str, a.shape, a.tobytes())
        arrays.append(got)
    assert metas[0] == metas[1]
    names = [e["name"] for e in metas[1]["leaves"]]
    assert "1/.step" in names and "1/.nu/m" in names
    assert "0/blocks/1/w" in names and "0/embed" in names
    # at 16 bytes a shard: the six parameter leaves one each, the
    # optimizer's step and moments the seventh
    assert len({e["shard"] for e in metas[1]["leaves"]}) == (
        1 if shard_bytes is None else 7)
    assert arrays[0] == arrays[1]


def test_each_store_restores_the_others_commit(tmp_path):
    """The port restores the reference's commit (bfloat16 included) and
    the reference restores the port's: every leaf equal, dtype
    included, each package's AdamW state rebuilt.  The reference's
    ``restore`` cannot read a bfloat16 leaf back, its own commit's
    either (ROADMAP queue 3), so that direction holds the tree without
    one."""
    ours, theirs = _tree_pair()
    jstore.save(str(tmp_path / "ref"), 2, theirs)
    got, step = restore(str(tmp_path / "ref"), ours, device="cpu")
    assert step == 2 and isinstance(got[1], AdamWState) and got[2] is None
    _assert_same(ours, got)

    ours, theirs = _tree_pair(bf16=False)
    save(str(tmp_path / "port"), 3, ours)
    back, step = jstore.restore(str(tmp_path / "port"), theirs)
    assert step == 3 and isinstance(back[1], JaxAdamWState)
    assert back[2] is None
    want, have = jax.tree.leaves(theirs), jax.tree.leaves(back)
    assert len(want) == len(have)
    for a, b in zip(want, have):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_resume_from_reference_commit_matches_reference_train(tmp_path):
    """The reference's train() commits its init (a 0-step run) and runs
    20 steps.  The port reads that commit with its own store, converts
    it, runs to step 12 with a commit at 10, loses the step-12 commit
    and resumes to 20: its losses, before and after the resume, are the
    reference's, and so are its final parameters and moments."""
    vocab = 128
    jcfg = jax_config("smollm-135m").reduced(num_layers=2, d_model=48,
                                              d_ff=96, vocab_size=vocab,
                                              num_heads=4, num_kv_heads=2,
                                              head_dim=12)
    japi = jax_model(jcfg)
    pipe = dict(global_batch=8, seq_len=32, vocab_size=vocab, seed=11)
    jopt = JaxAdamWConfig(lr=1e-3)
    jroot = str(tmp_path / "ref")
    jax_train(japi, jopt, JaxTrainConfig(
        total_steps=0, checkpoint=JaxCheckpointConfig(
            jroot, async_save=False)),
              lambda s: jax_lm_batch_at(JaxPipelineConfig(**pipe), s))
    ref = jax_train(japi, jopt, JaxTrainConfig(total_steps=20),
                    lambda s: jax_lm_batch_at(JaxPipelineConfig(**pipe), s))
    ref_losses = [h["loss"] for h in ref["history"]]
    assert jstore.committed_steps(jroot) == [0]

    # the reference's commit, read by the port's store into the
    # reference's structure (stacked layers), then converted
    like = jax.tree.map(np.asarray, (ref["params"], ref["opt_state"]))
    (jp, jo), step = restore(jroot, like, device="cpu")
    assert step == 0 and isinstance(jo, JaxAdamWState)
    tcfg = get_config("smollm-135m").reduced(num_layers=2, d_model=48,
                                             d_ff=96, vocab_size=vocab,
                                             num_heads=4, num_kv_heads=2,
                                             head_dim=12)
    init = (params_from_jax(jp, tcfg, device="cpu"),
            AdamWState(step=jo.step, mu=params_from_jax(jo.mu, tcfg,
                                                        device="cpu"),
                       nu=params_from_jax(jo.nu, tcfg, device="cpu")))
    root = str(tmp_path / "port")
    save(root, 0, init)

    api = get_model(tcfg)
    batch_fn = (lambda s: lm_batch_at(PipelineConfig(**pipe), s))
    ck = CheckpointConfig(root, every_steps=10, async_save=False)
    first = train(api, AdamWConfig(lr=1e-3),
                  TrainConfig(total_steps=12, checkpoint=ck), batch_fn,
                  device="cpu")
    assert committed_steps(root) == [0, 10, 12]
    import shutil
    shutil.rmtree(os.path.join(root, "step_00000012"))
    resumed = train(api, AdamWConfig(lr=1e-3),
                    TrainConfig(total_steps=20, checkpoint=ck), batch_fn,
                    device="cpu")
    assert [h["step"] for h in resumed["history"]] == list(range(10, 20))
    np.testing.assert_allclose([h["loss"] for h in first["history"]],
                               ref_losses[:12], rtol=1e-4)
    np.testing.assert_allclose([h["loss"] for h in resumed["history"]],
                               ref_losses[10:], rtol=1e-4)

    want = jax.tree.map(np.asarray, (ref["params"], ref["opt_state"]))
    want = (params_from_jax(want[0], tcfg, device="cpu"),
            params_from_jax(want[1].mu, tcfg, device="cpu"),
            params_from_jax(want[1].nu, tcfg, device="cpu"))
    have = (resumed["params"], resumed["opt_state"].mu,
            resumed["opt_state"].nu)
    assert int(resumed["opt_state"].step) == int(ref["opt_state"].step)
    for a, b in zip(tree_leaves(want), tree_leaves(have)):
        a, b = a.double(), b.detach().double()
        assert float((b - a).norm() / a.norm().clamp_min(1e-30)) <= 1e-4
