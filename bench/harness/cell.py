"""A cell as ``BENCHMARK.json`` names it, and the files it is made of.

A cell names a configuration and a traffic mix.  The configuration's
file is the one ``BENCHMARK.json`` gives it; the mix is
``bench/traffic/<traffic>.json``; each per-layer metric is read by
``bench/metrics/<metric name>.py``, a module whose ``read(r)`` returns a
number or None (nothing to read).  Which metrics a cell reports is what
``BENCHMARK.json`` says: those whose ``workloads`` name the cell, and
those without the key that move an end-to-end metric it reports.

A cell over several chips names its ("data", "model") mesh in its traffic
file, ``"mesh": {"data": D, "model": M}``, with D x M its ``chips``;
without the key the mesh is 1 x 1, on one chip.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

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
    mesh: Tuple[int, int] = (1, 1)   # (data, model)


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
    mesh = _mesh(workload, mix, w["chips"])
    e2e = [m for m in spec["end_to_end"]
           if _applies(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _applies(m, workload, names)]
    return Cell(workload, w["chips"], model, mix, e2e, per_layer, root,
                mesh)


def _mesh(workload: str, mix: dict, chips: int) -> Tuple[int, int]:
    """(data, model) of the traffic's ``mesh``, whose product has to be the
    cell's ``chips``."""
    mesh = mix.get("mesh", {"data": 1, "model": 1})
    if set(mesh) != {"data", "model"} or not all(
            isinstance(v, int) and v >= 1 for v in mesh.values()):
        raise SystemExit(f"cell {workload!r}: a mesh is {{\"data\": D, "
                         f"\"model\": M}} of whole numbers, not {mesh}")
    if mesh["data"] * mesh["model"] != chips:
        raise SystemExit(f"cell {workload!r}: its mesh data {mesh['data']} "
                         f"x model {mesh['model']} does not fill the "
                         f"{chips} chip(s) it asks for")
    return mesh["data"], mesh["model"]


_modules: Dict[Path, ModuleType] = {}


def module(path: Path) -> Optional[ModuleType]:
    """The benchmark's file ``path`` (a family, an attention, a per-layer
    metric: ``bench/<kind>/<name>.py``), loaded once a process; None where
    there is no such file."""
    if path not in _modules:
        if not path.is_file():
            return None
        spec = importlib.util.spec_from_file_location(
            f"bench_{path.parent.name}_"
            + re.sub(r"[^0-9A-Za-z_]", "_", path.stem), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def reader(name: str, root: Path = ROOT) -> Callable:
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    mod = module(root / "bench" / "metrics" / f"{name}.py")
    if mod is None:
        raise FileNotFoundError(f"the benchmark has no bench/metrics/"
                                f"{name}.py")
    return mod.read


def read_per_layer(cell: Cell, r) -> Dict[str, dict]:
    """Each per-layer metric of the cell that finds something to read."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"], cell.root)(r)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
