"""CLI: statically analyze the serving engine's hot path and write
``ANALYSIS_serve.json``.

Port of :mod:`repro.analysis.serve`, with its flags and exit codes:

    PYTHONPATH=src python -m repro_torch.analysis.serve --config paper_tiny
    PYTHONPATH=src python -m repro_torch.analysis.serve --config paper_tiny \
        --check-bench BENCH.json --out ANALYSIS_serve.json

The engine is built on the host and its steps walked on ``meta``
tensors: the analysis needs no card.  Exit status 1 when any proof
obligation fails: a step set over the declared retrace budget (an
unbucketed family, rwkv6-7b, fails here by construction), a signature
that cannot be built, an untagged host<->device site in the tick path, a
per-tick transfer count over the declared contract, a host sync inside a
step, or a bench artifact whose measured step counts exceed the proven
bound (a soundness bug in the enumeration); else 0.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.serve_static import (analyze_serve,
                                               cross_check_bench,
                                               format_serve_report)

#: default engine geometry: small enough to analyze in seconds, large
#: enough that every bucket family has >= 3 members
_DEFAULT_ENGINE_KW = dict(max_batch=4, max_len=128, page_size=16,
                          prefill_chunk=16)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.serve",
        description="Static serve-path analysis: retrace-budget proof, "
                    "host-sync audit, and per-signature roofline")
    ap.add_argument("--config", default="paper-tiny",
                    help="architecture id (default: paper-tiny; "
                         "underscores are normalized to dashes)")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the model (cfg.reduced() defaults) so "
                         "params init stays cheap")
    ap.add_argument("--allocators", default="paged,contiguous",
                    help="comma-separated allocator arms to prove")
    ap.add_argument("--max-batch", type=int,
                    default=_DEFAULT_ENGINE_KW["max_batch"])
    ap.add_argument("--max-len", type=int,
                    default=_DEFAULT_ENGINE_KW["max_len"])
    ap.add_argument("--page-size", type=int,
                    default=_DEFAULT_ENGINE_KW["page_size"])
    ap.add_argument("--prefill-chunk", type=int,
                    default=_DEFAULT_ENGINE_KW["prefill_chunk"])
    ap.add_argument("--budget", type=int, default=None,
                    help="declared total compile budget override "
                         "(default: derived from the config)")
    ap.add_argument("--check-bench", default=None,
                    help="bench JSON artifact: cross-check its measured "
                         "step counts against the proven bounds "
                         "re-derived from its recorded configs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="ANALYSIS_serve.json",
                    help="output JSON path ('-' for stdout only)")
    args = ap.parse_args(argv)

    allocators = [a.strip() for a in args.allocators.split(",") if a.strip()]
    engine_kw = dict(max_batch=args.max_batch, max_len=args.max_len,
                     page_size=args.page_size,
                     prefill_chunk=args.prefill_chunk)
    doc = analyze_serve(args.config, allocators=allocators,
                        engine_kw=engine_kw,
                        reduced={} if args.reduced else None,
                        declared_budget=args.budget, seed=args.seed)

    failures = []
    for alloc, arm in doc["allocators"].items():
        r = arm["retrace"]
        if not r["within_budget"]:
            failures.append(
                f"[{alloc}] compile set over budget: proven "
                f"{r['proven_total']} > declared {r['declared_total']} "
                f"(prefill {r['prefill']['proven']}/"
                f"{r['prefill']['declared']}, decode "
                f"{r['decode']['proven']}/{r['decode']['declared']})")
        if not arm["signatures"]["verified"]:
            failures.append(f"[{alloc}] signature verification failed: "
                            f"{arm['signatures'].get('error')}")
        if arm["roofline"]["jit_host_callbacks"]:
            failures.append(
                f"[{alloc}] {arm['roofline']['jit_host_callbacks']} host "
                f"sync(s) inside the static steps")
    audit = doc["sync_audit"]
    for site in audit["unallowlisted"]:
        failures.append(
            f"untagged sync: {site['path']}:{site['line']} {site['api']} "
            f"({site['kind']}) in {site['func']}()")
    if not audit["ok"] and not audit["unallowlisted"]:
        failures.append(
            f"per-tick sync contract violated: "
            f"h2d={audit['per_tick']['h2d']}/"
            f"{audit['declared_per_tick']['h2d']}, "
            f"d2h={audit['per_tick']['d2h']}/"
            f"{audit['declared_per_tick']['d2h']}")
    tel = doc["sync_audit_telemetry"]
    for site in tel["unallowlisted"]:
        failures.append(
            f"untagged sync in telemetry emit path: "
            f"{site['path']}:{site['line']} {site['api']} "
            f"({site['kind']}) in {site['func']}()")
    if not tel["ok"] and not tel["unallowlisted"]:
        failures.append(
            f"telemetry emit path is not transfer-free: "
            f"h2d={tel['per_tick']['h2d']}, d2h={tel['per_tick']['d2h']} "
            f"(declared 0 + 0)")
    if args.check_bench:
        with open(args.check_bench) as f:
            doc["cross_check"] = cross_check_bench(json.load(f))
        for arm in doc["cross_check"]["arms"].values():
            failures.extend(arm["failures"])
    doc["ok"] = doc["ok"] and not failures

    print(format_serve_report(doc))
    if args.out != "-":
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        print(f"wrote {args.out}")

    for msg in failures:
        print(f"ANALYSIS FAILURE: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
