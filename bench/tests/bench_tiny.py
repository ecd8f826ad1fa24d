"""Small copies of the benchmark's cells for the harness's CPU tests: the
cell's configuration file with small widths, and the program's
configuration cut to the same sizes (float32 compute, no remat), at the
sizes the configuration's family gives (``small``, ``small_program``)."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT / "bench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def tiny_model(model: dict, size: str = "tiny") -> dict:
    from harness import families

    return families.of(model).small(model, size)


def program_config(model: dict, size: str = "tiny"):
    from harness import families

    return families.of(model).small_program(model, size)


def tiny_cell(name: str, size: str = "tiny", root: Path = ROOT, **mix):
    """The cell ``name`` of the checkout at ``root``, at a small size, its
    mix updated with ``mix``; returns (cell, the program's
    configuration)."""
    from harness import cell as cells

    c = cells.load(name, root)
    c.model = tiny_model(c.model, size)
    if c.mix["generator"] == "lm_stream":
        c.mix.update(batch=4, seq_len=48)
    else:
        c.model["serve"].update(max_batch=4, max_len=256)
        c.mix.update(prompt_len=[8, 100], output_len=[4, 24])
        if c.mix.get("rate"):
            c.mix.update(rate=25.0, ramp_s=0.5)
        else:
            c.mix.update(queue_depth=4)
    c.mix.update(mix)
    return c, program_config(c.model, size)


def scratch_checkout(root: Path, *, program: bool = False) -> Path:
    """A checkout of the benchmark at ``root``: ``BENCHMARK.json`` and
    ``bench/`` (with ``program``, the program's ``src/repro_torch`` too)."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    ignore = shutil.ignore_patterns("__pycache__")
    shutil.copytree(ROOT / "bench", root / "bench", ignore=ignore)
    if program:
        shutil.copytree(ROOT / "src" / "repro_torch",
                        root / "src" / "repro_torch", ignore=ignore)
    return root


def add_mesh_cell(root: Path, name: str = "smollm-inh.train-dp2tp2",
                  data: int = 2, model: int = 2, chips: int = 4) -> str:
    """Add, as files and entries alone, a training cell of the SmolLM
    configuration on a (data, model) mesh: the traffic ``lm-b8x1024`` with
    its ``mesh``, and the cell in ``BENCHMARK.json`` with the training
    cell's end-to-end metrics.  Returns the cell's name."""
    import json

    mix = json.loads((root / "bench/traffic/lm-b8x1024.json").read_text())
    mix["mesh"] = {"data": data, "model": model}
    traffic = f"lm-b8x1024-dp{data}tp{model}"
    (root / "bench/traffic" / f"{traffic}.json").write_text(json.dumps(mix))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name,
                              "config": "smollm-135m.inhibitor",
                              "traffic": traffic, "chips": chips,
                              "why": "the training cell on a mesh"})
    for m in spec["end_to_end"]:
        if "smollm-inh.train" in m.get("workloads", ()):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return name
