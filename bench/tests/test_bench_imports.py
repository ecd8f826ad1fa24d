"""Nothing the harness or its reference loads has the top-level name
``jax``, ``jaxlib``, ``flax`` or ``repro`` (compared whole:
``repro_torch`` is the program)."""

from __future__ import annotations

import subprocess
import sys

import bench_tiny

SCRIPT = """
import sys
sys.path[:0] = [{src!r}, {bench!r}]
import run
run.import_paths()
from harness import (cell, checks, readers, reference, roofline, runner,
                     serve, stats, trace, traffic, train, weights)
import control, sweep
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_train_step
from repro_torch.optim import init_adamw
c = cell.load("smollm-inh.chat")
for m in c.per_layer:
    cell.reader(m["name"])
print(run.loaded_forbidden())
"""


def test_no_jax_module_is_loaded():
    code = SCRIPT.format(src=str(bench_tiny.ROOT / "src"),
                         bench=str(bench_tiny.ROOT / "bench"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_names(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "repro_torchlike", sys)
    assert "repro" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in run.loaded_forbidden()
