"""Find the highest arrival rate an open-loop serving cell sustains: one
engine, a window of ``--seconds`` at each rate in turn (drained between,
each rate's prompts drawn from a seed of its own),
each printing the requests due, those waiting when the window closed, and
the tails; the knee is the last rate whose backlog does not grow.  The
benchmark's runs do not run this; it fixes a mix's ``rate`` once.

    python3 bench/sweep.py --workload <cell> --seed 5 --seconds 20 --rates 2 4 6 8
"""

from __future__ import annotations

import argparse
import json
import time

import run as bench_run


def _by_chunks(ticks, w0, w1) -> dict:
    """Per count of prefill chunks a tick ran: ticks, and their mean and
    largest host ms."""
    out = {}
    for t in ticks:
        if w0 <= t["t0"] < w1:
            out.setdefault(t["prefill_chunks"], []).append(
                (t["t1"] - t["t0"]) * 1e3)
    return {k: [len(v), sum(v) / len(v), max(v)]
            for k, v in sorted(out.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench_run.set_caches()
    bench_run.import_paths()

    import torch

    from harness import cell as cells
    from harness import runner, serve, traffic, weights
    from harness.stats import percentile
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import Engine

    cell = cells.load(args.workload)
    device = torch.device("cuda", 0)
    api = get_model(runner.program_config(cell.model))
    params = weights.draw(cell.model, args.seed, device)
    eng = Engine(api, params, serve.engine_config(cell.model["serve"], False),
                 seed=args.seed, device=device)
    for i, rate in enumerate(args.rates):
        # a seed of its own at each rate: prompts served at an earlier rate
        # would be prefix-cache hits at the next
        mix = dict(cell.mix, rate=rate)
        plan = traffic.requests(mix, cell.model["vocab_size"], args.seed + i)
        origin = time.perf_counter()
        drv = serve.Driver(eng, plan, origin, mix)
        w0 = origin + mix["ramp_s"]
        w1 = w0 + args.seconds
        drv.drive(until=w1)
        torch.cuda.synchronize()
        backlog = len(eng.scheduler) + len(eng.admitting)
        tl = drv.timeline
        due = [r for r, t in tl.due.items() if w0 <= t < w1]
        line = {"rate": rate, "due": len(due),
                "finished": sum(w0 <= t <= w1 for t in tl.finished.values()),
                "backlog_at_close": backlog,
                "ttft_p50_ms": percentile(tl.ttft_ms(w0, w1), 50),
                "ttft_p90_ms": percentile(tl.ttft_ms(w0, w1), 90),
                "itl_p95_ms": percentile(tl.itl_ms(w0, w1), 95),
                "ticks": sum(w0 <= t["t0"] < w1 for t in drv.ticks),
                "tick_ms_by_chunks": _by_chunks(drv.ticks, w0, w1)}
        print(json.dumps(line), flush=True)
        if backlog > 10 * rate:           # past the knee: stop climbing
            break
        while drv.busy():                 # drain before the next rate
            drv.tick()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
