"""A cell as ``BENCHMARK.json`` names it, and the files it is made of.

A cell names a configuration and a traffic mix.  The configuration's
file is the one ``BENCHMARK.json`` gives it; the mix is
``bench/traffic/<traffic>.json``; each per-layer metric is read by
``bench/metrics/<metric name>.py``, a module whose ``read(r)`` returns a
number or None (nothing to read).  Which metrics a cell reports is what
``BENCHMARK.json`` says: those whose ``workloads`` name the cell, and
those without the key that move an end-to-end metric it reports.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    model: dict                  # the configuration file
    mix: dict                    # the traffic file
    end_to_end: List[dict]       # the metrics this cell reports
    per_layer: List[dict]
    root: Path = ROOT


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of the benchmark at ``root`` (a checkout)."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark "
                         f"has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    model = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    e2e = [m for m in spec["end_to_end"]
           if _applies(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _applies(m, workload, names)]
    return Cell(workload, w["chips"], model, mix, e2e, per_layer, root)


def reader(name: str, root: Path = ROOT) -> Callable:
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell: Cell, r) -> Dict[str, dict]:
    """Each per-layer metric of the cell that finds something to read."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"], cell.root)(r)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
