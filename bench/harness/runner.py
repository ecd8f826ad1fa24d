"""One run of one cell: the program built from the cell's configuration,
the driver its traffic names, the metrics the cell reports, the verdict.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Callable, Optional

from harness import cell as cells
from harness import checks

DRIVERS = {"lm_stream": "train", "requests": "serve"}


def program_config(model: dict):
    """The program's configuration of ``model["arch"]``, held to every
    size the configuration file states."""
    import repro_torch
    from repro_torch.configs import get_config

    src = Path(repro_torch.__file__).resolve()
    if cells.ROOT / "src" not in src.parents:
        raise SystemExit(f"bench: the program was imported from {src}, "
                         f"outside this checkout")
    cfg = get_config(model["arch"])
    a = cfg.attention
    stated = {
        "num_hidden_layers": cfg.num_layers, "hidden_size": cfg.d_model,
        "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab_size,
        "num_attention_heads": a.num_heads,
        "num_key_value_heads": a.num_kv_heads, "head_dim": a.head_dim,
        "rope_theta": a.rope_base, "rms_norm_eps": cfg.norm_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
    }
    held = {"mechanism": a.mechanism, "score_shift": a.score_shift,
            "normalize": a.normalize, "causal": a.causal,
            "sliding_window": a.sliding_window, "norm": cfg.norm,
            "mlp": cfg.mlp, "remat": cfg.remat}
    want = dict(model["attention"], norm="rmsnorm", mlp="gated_silu",
                remat=model.get("train", {}).get("remat", cfg.remat))
    bad = {k: (v, model[k]) for k, v in stated.items() if model[k] != v}
    bad.update({k: (held[k], want[k]) for k in held if k in want
                and held[k] != want[k]})
    if bad:
        raise SystemExit(f"bench: the program's {model['arch']} differs from "
                         f"the configuration file: {bad}")
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
        dev["busy_s"] = tr.busy_us() * 1e-6
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
