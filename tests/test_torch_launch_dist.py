"""The training launcher over a mesh (repro_torch.launch.train): under
``torchrun`` with 4 gloo ranks, ``--data-parallel 2 --model-parallel 2``
trains through the sharded step with the one-process run's losses; a
mesh larger than the world exits with the reference's message."""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           OMP_NUM_THREADS="1")
ARGS = ["--device", "cpu", "--steps", "6"]


def _summary(stdout: str) -> dict:
    return json.loads([ln for ln in stdout.splitlines()
                       if ln.startswith("{")][-1])


def test_torchrun_mesh_trains_with_the_one_process_losses():
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *ARGS], cwd=ROOT, env=ENV, capture_output=True,
                         text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    four = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *ARGS,
         "--data-parallel", "2", "--model-parallel", "2"],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=300)
    assert four.returncode == 0, four.stderr[-3000:]
    a, b = _summary(one.stdout), _summary(four.stdout)
    assert b["mesh"] == [2, 2] and a["mesh"] == [1, 1]
    assert len(b["losses"]) == 6
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-5)
    # rank 0 alone prints the summary
    assert sum(ln.startswith("{") for ln in four.stdout.splitlines()) == 1


def test_mesh_larger_than_the_world_exits_with_the_reference_message():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *ARGS, "--data-parallel", "2", "--model-parallel",
                        "2"], cwd=ROOT, env=ENV, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "mesh 2x2 needs 4 devices, have 1" in r.stderr
