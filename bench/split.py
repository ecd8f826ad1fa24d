"""Split a cell's time by the program's own spans and ranges; the
benchmark's runs do not run this.

    python3 bench/split.py --workload <cell> --seed <n> --seconds <s>

Prints one JSON line of each kind:

* ``ttft`` (open-loop serving cells only, first): a ramp and a window of
  the cell's traffic with the engine's telemetry on; each TTFT of the
  window split by the engine's request spans into the harness's submit
  lag, ``queued``, ``prefill`` and the rest, at the mean and over the
  requests at or beyond the p90 (``harness.spans.ttft_split``);
* ``traced``: one traced run of the cell as ``bench/run.py --trace 1``
  makes it: its end-to-end metrics (from a window in which the engine's
  telemetry is on: against an untraced run of the same seed, the cost of
  the telemetry), its per-layer metrics and breakdown (whose
  ``idle_gaps`` name the idle time by the innermost range holding it),
  the device ms under each ``repro_torch.*`` range of the traced slice,
  for training the share of the steps' busy device time under the train
  ranges, and for serving the prefill chunks each tick of the window and
  of the traced slice ran, and the share of the window's runs of
  ``trace_ticks`` ticks that ran none.

``ttft_pass`` drives the open loop as ``harness.serve.run`` does, in a
second copy, only because that file gives its readers no tracer events.
The ``benchmark`` change that hands ``r`` the tracer's events, its
``origin`` and the window's bounds deletes ``ttft_pass``: the means of
``queued`` and ``prefill`` become metrics, and this script reads
``harness.spans.ttft_split`` from that ``r``.
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from typing import Callable, Optional

import run as bench_run


def ttft_pass(cell, api, seed: int, seconds: float, device,
              sync: Callable[[], None]) -> Optional[dict]:
    from harness import serve, spans, traffic, weights
    from repro_torch.serve.engine import Engine

    params = weights.draw(cell.model, seed, device)
    eng = Engine(api, params, serve.engine_config(cell.model["serve"], True),
                 seed=seed, device=device)
    plan = traffic.requests(cell.mix, cell.model["vocab_size"], seed)
    origin = time.perf_counter()
    drv = serve.Driver(eng, plan, origin, cell.mix)
    drv.drive(until=origin + cell.mix["ramp_s"])
    sync()
    w0 = time.perf_counter()
    drv.drive(until=w0 + seconds)
    sync()
    w1 = time.perf_counter()
    drv.submit_due(w1)
    return spans.ttft_split(drv.timeline, eng.tel.events, eng.tel.origin,
                            w0, w1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    bench_run.set_caches()
    bench_run.import_paths()

    import torch

    from harness import cell as cells
    from harness import runner, spans
    from repro_torch.models.registry import get_model

    cell = cells.load(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    if cell.mix.get("rate"):
        api = get_model(runner.program_config(cell.model))
        split = ttft_pass(cell, api, args.seed, args.seconds, device,
                          torch.cuda.synchronize)
        print(json.dumps({"ttft": split}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    result, out = runner.run_cell(cell, args.seed, args.seconds, True,
                                  device, time.perf_counter(),
                                  sync=torch.cuda.synchronize)
    tr = out["r"].trace
    line = {"e2e": out["e2e"], "metrics": result["metrics"],
            "correct": result["correct"], "device": result["device"],
            "breakdown": result.get("breakdown"),
            "device_ms_by_range": spans.device_ms_by_range(tr)}
    if out["r"].kind == "train":
        line["train_coverage_pct"] = spans.train_coverage(tr)
    else:
        window = [t["prefill_chunks"] for t in out["r"].window_ticks]
        line["window_chunks"] = window
        line["traced_chunks"] = [t["prefill_chunks"]
                                 for t in out["r"].tail_ticks]
        line["window_chunkless_share"] = spans.chunkless_share(
            window, cell.mix["trace_ticks"])
    print(json.dumps({"traced": line}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
