"""The readings the limits of ``correct`` are set from, on the chip at a
cell's own size; the benchmark's runs do not run this.

    python3 bench/control.py --workload <cell> --seeds 11 12 13 [--fault half_batch]

For each seed, one line of JSON:

* a training cell: the control, the reference computed in float8 (e4m3,
  one scale a tensor) in the program's place, read against the float32
  reference over the checked steps; with ``--fault half_batch`` the
  program with half of every batch left out, read the same way (a step
  that returns its state unchanged reads 1 on ``change_gap`` by
  construction and needs no run);
* a serving cell: a window of ``--seconds`` at the cell's own load, then
  the program's reading (``logit_gap`` of its served tokens) and the
  control's: at each position of the same prompts and served tokens, the
  reference's gap of the token that the float8 reference puts first.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    bench_run.set_caches()
    bench_run.import_paths()

    import torch

    from harness import cell as cells
    from harness import checks, runner, serve, train
    from repro_torch.models.registry import get_model

    cell = cells.load(args.workload)
    device = torch.device("cuda", 0)
    cfg = runner.program_config(cell.model)
    api = get_model(cfg)
    kind = runner.DRIVERS[cell.mix["generator"]]
    for seed in args.seeds:
        t0 = time.perf_counter()
        if kind == "train":
            ref = train.reference_train(cell, seed, device)
            if args.fault:
                step_fn, params, opt, paths, ocfg = train.program(
                    cell, api, seed, device, fault=args.fault)
                other, _, _ = train.first_steps(cell, step_fn, params, opt,
                                                paths, ocfg, seed, device)
                del step_fn, params, opt
            else:
                other = train.reference_train(cell, seed, device, prec="fp8")
            line = {"seed": seed, "of": args.fault or "control_fp8",
                    **checks.train_readings(other, ref)}
        else:
            res, out = runner.run_cell(cell, seed, args.seconds, False,
                                       device, t0,
                                       sync=torch.cuda.synchronize)
            ctl = 0.0
            for prompt, output in out["_seqs"]:
                ref_lg = serve.reference_logits(out["_params"], cell.model,
                                                prompt, output, device)
                low = serve.reference_logits(out["_params"], cell.model,
                                             prompt, output, device,
                                             prec="fp8")
                ctl = max(ctl, checks.served_gap(ref_lg, low.argmax(-1)))
                del ref_lg, low
            line = {"seed": seed, "program_logit_gap":
                    out["readings"]["logit_gap"], "control_fp8_logit_gap": ctl,
                    "checked_tokens": out["notes"]["checked_tokens"],
                    "metrics": res["metrics"]}
            del out
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    found = bench_run.loaded_forbidden()
    if found:
        print(f"control: JAX modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
