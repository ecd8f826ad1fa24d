"""CLI: statically analyze a named config and write ANALYSIS_fhe.json.

    PYTHONPATH=src python -m repro_torch.analysis --config paper-tiny \
        --seq-len 8 --out ANALYSIS_fhe.json

Port of ``python -m repro.analysis``: the same flags, document and exit
codes.  The analysis runs on the host (exact int64 bounds) and needs no
card.

Exit status is non-zero when any analyzed mechanism fails its structural
obligations: an inhibitor-family arm with a statically reachable
cipher×cipher multiply, an unverified LUT table width, or an
unselectable parameter point.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.analyzer import (DEFAULT_MECHANISMS,
                                           analyze_config, format_report)

_INHIBITOR_FAMILY = ("inhibitor", "inhibitor_unsigned")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static FHE circuit analysis (interval abstract "
                    "interpretation) of a PTQ'd config")
    ap.add_argument("--config", default="paper-tiny",
                    help="architecture id (default: paper-tiny)")
    ap.add_argument("--mechanisms", default=",".join(DEFAULT_MECHANISMS),
                    help="comma-separated mechanism list")
    ap.add_argument("--seq-len", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="ANALYSIS_fhe.json",
                    help="output JSON path ('-' for stdout only)")
    args = ap.parse_args(argv)

    mechs = [m.strip() for m in args.mechanisms.split(",") if m.strip()]
    doc = analyze_config(args.config, seq_len=args.seq_len,
                         batch=args.batch, mechanisms=mechs,
                         seed=args.seed)

    failures = []
    for mech, report in doc["mechanisms"].items():
        print(format_report(report))
        print()
        if mech in _INHIBITOR_FAMILY and not report["zero_cmul_proven"]:
            failures.append(f"{mech}: cipher×cipher multiply statically "
                            f"reachable ({report['cmul_sites']})")
        if not report["lut_verification"]["verified"]:
            failures.append(f"{mech}: LUT table width beyond the ceiling "
                            f"({report['lut_verification']['violations']})")
        if report.get("params") is None:
            failures.append(f"{mech}: {report.get('params_error')}")

    if args.out != "-":
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        print(f"wrote {args.out}")

    for msg in failures:
        print(f"ANALYSIS FAILURE: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
