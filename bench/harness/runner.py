"""One run of one cell: the program built from the cell's configuration,
the driver its traffic names, the metrics the cell reports, the verdict.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Callable, Optional

from harness import cell as cells
from harness import checks, families

DRIVERS = {"lm_stream": "train", "requests": "serve"}


def program_config(model: dict):
    """The program's configuration of ``model["arch"]``, held by the
    configuration's family to every size and choice the file states."""
    import repro_torch
    from repro_torch.configs import get_config

    src = Path(repro_torch.__file__).resolve()
    if cells.ROOT / "src" not in src.parents:
        raise SystemExit(f"bench: the program was imported from {src}, "
                         f"outside this checkout")
    cfg = get_config(model["arch"])
    families.of(model).check(model, cfg)
    return cfg


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, *, sync: Callable[[], None] = lambda: None,
             fault: Optional[str] = None, cfg=None):
    """Run the cell; return the result line's object and the driver's
    own record.  ``cfg``
    replaces the program's configuration (the harness's own tests run a
    small one on the CPU); ``fault`` plants a fault in the timed path."""
    from repro_torch.models.registry import get_model

    cfg = program_config(cell.model) if cfg is None else cfg
    api = get_model(cfg)
    kind = DRIVERS[cell.mix["generator"]]
    if cell.chips > 1 and kind != "train":
        raise SystemExit(f"bench: {cell.name}: only a training cell runs "
                         f"over several chips")
    if kind == "train":
        from harness import train as driver
    else:
        from harness import serve as driver
    out = driver.run(cell, api, seed, seconds, trace, device, t_start,
                     fault=fault, sync=sync)
    limits = checks.limits_of(cell.model, kind)
    correct, shown = checks.verdict(out["readings"], limits)
    if trace:
        metrics = cells.read_per_layer(cell, out["r"])
    else:
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in out["e2e"]]
        if missing:
            raise SystemExit(f"bench: the {kind} driver measures none of "
                             f"{missing}")
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_name(device), "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    tr = out["r"].trace
    if trace and tr is not None:
        # over several chips the ranks' mean
        busy = out["busy_us"] if "busy_us" in out else tr.busy_us()
        dev["busy_s"] = busy * 1e-6
        dev["window_s"] = (tr.hi - tr.lo) * 1e-6
        result["breakdown"] = tr.breakdown()
    print(f"bench: {cell.name} seed {seed} setup_s {out['e2e']['setup_s']!r} "
          f"reference_s {out['reference_s']!r} notes {out.get('notes')}",
          file=sys.stderr)
    result["checks"] = shown
    return result, out


def _device_name(device) -> str:
    if device.type != "cuda":
        return device.type
    import torch

    return torch.cuda.get_device_name(device)
