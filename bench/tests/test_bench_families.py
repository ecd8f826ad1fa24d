"""Architecture families as files: a configuration names its family, the
harness finds ``bench/families/<family>.py`` by that name, and a family
added as a file alone is found; an unknown family is refused by name."""

from __future__ import annotations

import json
import subprocess
import sys

import bench_tiny
import pytest
import torch

from harness import cell as cells
from harness import families, reference, runner, weights

TOY = '''
"""A family planted for the test: the dense family with one more leaf."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "toy_dense", Path(__file__).with_name("dense.py"))
_dense = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_dense)
check, logits, loss = _dense.check, _dense.logits, _dense.loss
small, small_program = _dense.small, _dense.small_program
MARK = "toy"


def layout(model):
    return _dense.layout(model) + [(("toy", "decay"), (3,), "const:-6")]


def fill(leaf, init):
    leaf.fill_(float(init.split(":")[1]))
'''

PROBE = """
import sys
sys.path[:0] = [{bench!r}, {src!r}]
import torch
from harness import cell, families, weights
c = cell.load("toy.chat")
c.model.update(num_hidden_layers=1, vocab_size=64)
drawn = weights.draw(c.model, 3, torch.device("cpu"))
print(families.of(c.model).MARK, weights.paths(drawn)[-1],
      drawn["toy"]["decay"].tolist())
"""


def test_a_family_added_as_a_file_is_found(tmp_path):
    root = bench_tiny.scratch_checkout(tmp_path)
    (root / "bench/families/toy.py").write_text(TOY)
    conf = json.loads((root / "bench/configs/smollm-135m.inhibitor.json")
                      .read_text())
    conf["family"] = "toy"
    (root / "bench/configs/toy.json").write_text(json.dumps(conf))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy", "source": "x",
                            "file": "bench/configs/toy.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "toy.chat", "config": "toy",
                              "traffic": "chat-open-loop", "chips": 1,
                              "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(bench=str(root / "bench"),
                                            src=str(bench_tiny.ROOT / "src"))],
        capture_output=True, text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["toy", "('toy',", "'decay')", "[-6.0,",
                                  "-6.0,", "-6.0]"]


def test_an_init_no_one_fills_is_refused():
    model = cells.load("smollm-inh.train").model
    with pytest.raises(ValueError, match="const:1"):
        weights.fill(model, torch.zeros(2), "const:1")


def test_an_unknown_family_is_refused_by_name():
    model = dict(cells.load("smollm-inh.train").model, family="no-such")
    for call in (lambda: families.of(model),
                 lambda: weights.layout(model),
                 lambda: runner.program_config(model),
                 lambda: reference.loss({}, model, None, None)):
        with pytest.raises(ValueError, match="'no-such'"):
            call()


@pytest.mark.parametrize("name", ["smollm-inh.train", "llava7b-inh.batch"])
def test_both_configurations_run_through_the_dense_family(name):
    model = cells.load(name).model
    assert "family" not in model and families.name(model) == "dense"
    assert families.of(model).__file__.endswith("bench/families/dense.py")
    runner.program_config(model)
    for key, value in (("hidden_size", 8), ("rms_norm_eps", 1e-6)):
        with pytest.raises(SystemExit, match=key):
            runner.program_config(dict(model, **{key: value}))
    with pytest.raises(SystemExit, match="causal"):
        runner.program_config(dict(model, attention=dict(
            model["attention"], causal=False)))


def test_small_sizes_come_from_the_family():
    model = cells.load("smollm-inh.chat").model
    tiny = bench_tiny.tiny_model(model)
    assert tiny["hidden_size"] == families.of(model).SMALL["tiny"][
        model["arch"]]["d"]
    cfg = bench_tiny.program_config(tiny)
    assert cfg.d_model == tiny["hidden_size"]
    assert cfg.compute_dtype == "float32"
    assert torch.float32 == weights.draw(tiny, 1, torch.device("cpu"))[
        "embed"]["table"].dtype
