"""The benchmark is driven by data: a cell, a configuration, a traffic mix
or a per-layer metric added only as files and entries is found by name,
and ``BENCHMARK.json`` keeps to the contract's shape."""

from __future__ import annotations

import json
import re

import bench_tiny
import pytest

from harness import cell as cells

ROOT = cells.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_cell_added_as_files_is_found(tmp_path):
    root = bench_tiny.scratch_checkout(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / "bench/configs/smollm-135m.inhibitor.json")
                      .read_text())
    conf["serve"]["max_batch"] = 32
    (root / "bench/configs/smollm-small-batch.json").write_text(
        json.dumps(conf))
    mix = json.loads((root / "bench/traffic/chat-open-loop.json").read_text())
    mix["rate"] = 1.5
    (root / "bench/traffic/chat-slow.json").write_text(json.dumps(mix))
    (root / "bench/metrics/queue_len.chat-slow.py").write_text(
        "def read(r):\n    return 42.0\n")
    spec["configs"].append({"name": "smollm-small-batch", "source": "x",
                            "file": "bench/configs/smollm-small-batch.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "smollm.slow", "config":
                              "smollm-small-batch", "traffic": "chat-slow",
                              "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "queue_len.chat-slow", "unit": "n",
                              "better": "lower", "source": "program_counter",
                              "layer": "x", "moves": "ttft_p90_ms",
                              "workloads": ["smollm.slow"]})
    spec["end_to_end"][1]["workloads"].append("smollm.slow")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    c = cells.load("smollm.slow", root)
    assert c.model["serve"]["max_batch"] == 32
    assert c.mix["rate"] == 1.5
    assert [m["name"] for m in c.end_to_end] == ["ttft_p90_ms", "setup_s"]
    assert [m["name"] for m in c.per_layer] == ["queue_len.chat-slow"]
    assert cells.read_per_layer(c, object()) == {
        "queue_len.chat-slow": {"value": 42.0, "unit": "n"}}


def test_a_reader_that_finds_nothing_is_left_out(tmp_path):
    root = bench_tiny.scratch_checkout(tmp_path)
    c = cells.load("smollm-inh.chat", root)
    (root / "bench/metrics/mfu.chat.py").write_text(
        "def read(r):\n    return None\n")
    c.per_layer = [m for m in c.per_layer if m["name"] == "mfu.chat"]
    assert cells.read_per_layer(c, object()) == {}


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        cells.load("no-such-cell")


def test_benchmark_json_keeps_the_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["bench"] and 1 <= spec["run_seconds"] <= 51
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [c["name"] for c in spec["configs"]]
    cells_ = [w["name"] for w in spec["workloads"]]
    for n in names + cells_ + list(e2e) + [m["name"] for m in
                                           spec["per_layer"]]:
        assert NAME.match(n), n
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/")
    for w in spec["workloads"]:
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (ROOT / "bench/traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200
        reported = {m["name"] for m in spec["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) >= 2
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert (ROOT / "bench/metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells_
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline") or "mfu" in m["name"] or \
                "_roofline." in m["name"]:
            assert m["unit"] == "%"
