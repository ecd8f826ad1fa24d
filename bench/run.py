"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix
and its per-layer metrics come from ``BENCHMARK.json`` and the files under
``bench/``.  The program under test is the PyTorch port in ``src/``; nothing
of the JAX package, and no JAX, is imported.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit, which also close
standard error.  The run exits non-zero, with no result, without enough
CUDA devices, without the program, or when JAX has been loaded.

A cell over several chips runs one process a rank, started from here
(``harness/ranks.py``); this process keeps the clock that ``setup_s``
starts from, runs the reference once the ranks have ended and prints the
one result line.

Every cache the program builds stays in the checkout: the kernel library
in ``build/kernels/`` (the program's own), the CUDA JIT, Triton and
extension caches under ``build/bench-cache/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """Top-level names in ``sys.modules`` that belong to JAX or the JAX
    package, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_caches() -> None:
    cache = ROOT / "build" / "bench-cache"
    for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)


def import_paths() -> None:
    for p in (ROOT / "src", ROOT / "bench"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches()
    import_paths()

    import torch

    from harness import cell as cells

    cell = cells.load(args.workload)
    try:
        import repro_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"bench: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"bench: the cell needs {cell.chips} CUDA device(s), {found} "
              "found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if cell.chips == 1:
        torch.cuda.set_device(device)
    # else no card is touched here until the ranks, a process a card,
    # have ended (harness/ranks.py)
    from harness import runner

    out, _ = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device, T_START,
                          sync=torch.cuda.synchronize)
    gc.collect()
    found = loaded_forbidden()
    if found:
        print(f"bench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
