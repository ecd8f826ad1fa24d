"""A training cell over several chips, added as files alone: its traffic
names the mesh, one process a rank runs the program's sharded step, and
the reference follows with its layers spread over the cell's devices.
These run four gloo ranks on the CPU, past the harness's look for cards."""

from __future__ import annotations

import json
import time

import bench_tiny
import pytest
import torch
from torch.utils.checkpoint import CheckpointError

from harness import cell as cells
from harness import reference, runner, train, weights

CPU = torch.device("cpu")


def _mesh_run(tmp_path, fault=None, seed=21):
    root = bench_tiny.scratch_checkout(tmp_path)
    name = bench_tiny.add_mesh_cell(root)
    c, cfg = bench_tiny.tiny_cell(name, root=root)
    assert (c.chips, c.mesh) == (4, (2, 2))
    return c, cfg, runner.run_cell(c, seed, 1.0, False, CPU,
                                   time.perf_counter(), cfg=cfg, fault=fault)


def test_four_ranks_match_one(tmp_path):
    # gloo on the CPU cannot see the (2, 2) mesh's fault on the cards
    # (test_a_two_by_two_cell_fails_in_the_recompute_on_the_cards): here
    # autograd runs the remat recompute on the calling thread, which holds
    # the program's thread-local mesh; on a card it runs on autograd's
    # device thread, which does not.
    c, cfg, (res, out) = _mesh_run(tmp_path)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 4
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert 0 < out["e2e"]["setup_s"]
    # the same seed on one rank, through the unsharded step
    one, cfg1 = bench_tiny.tiny_cell("smollm-inh.train")
    _res1, out1 = runner.run_cell(one, 21, 1.0, False, CPU,
                                  time.perf_counter(), cfg=cfg1)
    for key in ("losses", "grad_norms", "change_norms"):
        torch.testing.assert_close(
            torch.tensor(out["program"][key], dtype=torch.float64),
            torch.tensor(out1["program"][key], dtype=torch.float64),
            rtol=2e-5, atol=1e-8)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_faults_are_caught_on_the_mesh(tmp_path, fault):
    _c, _cfg, (res, _out) = _mesh_run(tmp_path, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("data,model,chips", [(2, 1, 4), (2, 2, 2),
                                              (1, 1, 4), (3, 1, 4)])
def test_a_mesh_that_does_not_fill_the_chips_is_refused(tmp_path, data,
                                                        model, chips):
    root = bench_tiny.scratch_checkout(tmp_path)
    name = bench_tiny.add_mesh_cell(root, "odd", data, model, chips)
    with pytest.raises(SystemExit, match="mesh"):
        cells.load(name, root)


def test_without_a_mesh_a_cell_takes_one_chip(tmp_path):
    root = bench_tiny.scratch_checkout(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"][0]["chips"] = 4
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert cells.load("smollm-inh.chat").mesh == (1, 1)
    with pytest.raises(SystemExit, match="mesh"):
        cells.load(spec["workloads"][0]["name"], root)


def test_the_reference_spread_over_devices_is_the_same(tmp_path):
    c, _cfg = bench_tiny.tiny_cell("llava7b-inh.batch")
    c.mix.update(generator="lm_stream", batch=3, seq_len=24)
    c.model["train"] = json.loads(
        (cells.ROOT / "bench/configs/smollm-135m.inhibitor.json")
        .read_text())["train"]
    one = train.reference_train(c, 11, CPU)
    assert train.reference_train(c, 11, [CPU] * 4) == one
    assert train.reference_train(c, 11, [CPU] * 3, prec="fp8") == \
        train.reference_train(c, 11, CPU, prec="fp8")
    drawn = weights.draw(c.model, 11, CPU)
    spread = reference.spread(drawn, [CPU] * 4)
    assert weights.paths(spread) == weights.paths(drawn)
    toks = torch.arange(24)[None] % c.model["vocab_size"]
    with torch.no_grad():
        assert torch.equal(reference.logits(spread, c.model, toks),
                           reference.logits(drawn, c.model, toks))


def test_spread_puts_each_layer_on_one_device():
    devs = ["a", "b", "c", "d"]

    class Leaf:
        def detach(self):
            return self

        def to(self, dev, copy):
            out = Leaf()
            out.device = dev
            return out

        def requires_grad_(self, _on):
            return self

    tree = {"embed": {"table": Leaf()},
            "blocks": [{"w": Leaf(), "v": [Leaf()]} for _ in range(6)],
            "final_norm": {"scale": Leaf()}}
    out = reference.spread(tree, devs)
    assert [b["w"].device for b in out["blocks"]] == \
        ["a", "a", "b", "c", "c", "d"]
    assert [b["v"][0].device for b in out["blocks"]] == \
        [b["w"].device for b in out["blocks"]]
    assert out["embed"]["table"].device == "a"
    assert out["final_norm"]["scale"].device == "a"


def _on_the_cards(root, name, seed, trace):
    """The result line of one short run of ``name`` in the checkout
    ``root``; a rank's ``CheckpointError`` is raised here as one."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", name, "--seed",
         str(seed), "--seconds", "5", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1500, cwd=root)
    if out.returncode and "CheckpointError" in out.stderr:
        raise CheckpointError(out.stderr[-6000:])
    assert out.returncode == 0, out.stderr[-6000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps(res))
    print(out.stderr.strip().splitlines()[-4])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == 4
    assert list(res)[-1] == "checks"
    return res


def _four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")


@pytest.mark.cuda
def test_a_four_chip_cell_runs_on_the_cards(tmp_path):
    # a scratch cell in a checkout of its own, never committed: the
    # SmolLM training cell on a (data 4, model 1) mesh, one process a
    # card; an untraced run, then a traced one.
    _four_cards()
    root = bench_tiny.scratch_checkout(tmp_path, program=True)
    name = bench_tiny.add_mesh_cell(root, "smollm-inh.train-dp4", 4, 1)
    for trace in (0, 1):
        res = _on_the_cards(root, name, 2147483777 + trace, trace)
        if trace:
            assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
            assert res["breakdown"]["device_ops"]
        else:
            assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.cuda
@pytest.mark.xfail(strict=True, raises=CheckpointError, reason=(
    "the program's remat recompute runs on autograd's device thread, where "
    "distributed/sharding.py's thread-local mesh is not set: the recompute "
    "splits no region over `model` and fails the checkpoint's shape check; "
    "this test passes, and so fails as strict, once the program carries "
    "the mesh into the recompute"))
def test_a_two_by_two_cell_fails_in_the_recompute_on_the_cards(tmp_path):
    # the scratch cell on the (data 2, model 2) mesh that the first
    # four-chip cell, rwkv6-7b.train-dp2tp2, asks for; untraced
    _four_cards()
    root = bench_tiny.scratch_checkout(tmp_path, program=True)
    name = bench_tiny.add_mesh_cell(root)
    _on_the_cards(root, name, 2147483779, 0)
