"""On the card: one short run of a cell through ``bench/run.py`` prints a
result line the contract reads, and the run refuses without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import bench_tiny
import pytest
import torch

RUN = str(bench_tiny.ROOT / "bench" / "run.py")


@pytest.mark.cuda
def test_a_short_run_prints_the_result_line():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, RUN, "--workload", "smollm-inh.chat", "--seed",
         "2147483659", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=bench_tiny.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert set(res["metrics"]) == {"ttft_p90_ms", "itl_p95_ms", "setup_s"}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, RUN, "--workload", "smollm-inh.chat", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=bench_tiny.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    bench_tiny.scratch_checkout(tmp_path)
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "smollm-inh.train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "program" in out.stderr
