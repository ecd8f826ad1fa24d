"""Static analysis of the port's serving hot path.

Port of the first two passes of :mod:`repro.analysis.serve_static`:

1. **Retrace-budget proof** — :func:`retrace_budget` enumerates every
   static step the engine can build from an ``EngineConfig`` (prefill
   chunk widths × decode table-width buckets), with the *same* pure
   scheduling functions the engine runs
   (``repro_torch.serve.engine.prefill_schedule`` /
   ``decode_table_width``), and proves the set finite and within the
   declared budget.  :func:`verify_chunk_resume` extends the proof to
   continuous batching: resuming a schedule at a chunk boundary
   reproduces its suffix, so interleaved prefill adds no step.  In the
   port a step is a captured ``torch.cuda.CUDAGraph`` on the card (the
   reference's jit trace); the engine checks its live counts against
   this proof when it drains (``Engine._check_compile_soundness``).

2. **Host-sync audit** — :func:`audit_sync_sites` walks the AST of
   ``serve/engine.py``, closes the tick-path call graph from
   ``Engine.step`` / ``run_to_completion``, and inventories every
   host→device upload and device→host read through torch's transfer
   surfaces (:func:`classify_sync_call`), each classed by its mandatory
   ``# sync: <required|eliminable|host> — <reason>`` tag.  A steady
   decode tick makes 2 h2d (the token batch, the block tables when
   dirty) and 1 d2h (the next tokens); the telemetry emit path makes
   none (:func:`audit_telemetry_file`).

The reference's third pass (the static roofline), the signature check
against a live engine and the analyzer CLI need ``jax.eval_shape`` and
the jaxpr cost model; they are not ported yet.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

__all__ = [
    "retrace_budget", "enumerate_prefill_buckets",
    "enumerate_decode_buckets", "verify_chunk_resume",
    "audit_sync_sites", "sync_summary", "tick_path_functions",
    "classify_sync_call", "find_sync_tag", "audit_engine_file",
    "audit_telemetry_file", "TELEMETRY_SYNC_ROOTS", "PER_TICK_DECLARED",
]


# --------------------------------------------------------------------------
# pass 1: retrace-budget proof
# --------------------------------------------------------------------------

def enumerate_prefill_buckets(*, max_len: int, prefill_chunk: int,
                              bucketed: bool, page_size: Optional[int] = None,
                              prefix_cache: bool = False) -> List[int]:
    """Every prefill chunk width reachable from the config: exhaustive
    over all admissible prompt lengths (1..max_len-1) and — when the
    prefix cache can shift the schedule start — every page-aligned
    credit the cache could grant.  Uses the engine's own pure
    ``prefill_schedule``, so the enumeration IS what the engine traces."""
    from repro_torch.serve.engine import prefill_schedule

    widths: Set[int] = set()
    for plen in range(1, max_len):
        starts: Sequence[int] = (0,)
        if prefix_cache and page_size:
            # admission caps the credit so >=1 prompt token is prefilled
            cap = ((plen - 1) // page_size) * page_size
            starts = range(0, cap + 1, page_size)
        for credit in starts:
            for _start, width in prefill_schedule(
                    plen, chunk=prefill_chunk, max_len=max_len,
                    bucketed=bucketed, start=credit):
                widths.add(width)
    return sorted(widths)


def enumerate_decode_buckets(*, max_len: int, page_size: int,
                             pages_per_slot: int) -> List[int]:
    """Every clamped block-table width a paged decode tick can trace:
    exhaustive over the longest-active-row positions 1..max_len."""
    from repro_torch.serve.engine import decode_table_width

    return sorted({decode_table_width(n, page_size=page_size,
                                      pages_per_slot=pages_per_slot)
                   for n in range(1, max_len + 1)})


def verify_chunk_resume(*, max_len: int, prefill_chunk: int,
                        bucketed: bool, page_size: Optional[int] = None,
                        prefix_cache: bool = False) -> Dict[str, Any]:
    """Prove chunk-granular resume (continuous batching, DESIGN.md §15)
    adds no trace signatures.

    The engine fixes a request's schedule at staging and indexes into it
    across ticks, but a paused-then-restaged admission (and the proof of
    the engine's *right* to do so) rests on the schedule being
    memoryless in the resume position: for every admissible
    ``(prompt_len, credit)`` pair, recomputing the schedule at the first
    chunk boundary (``start = min(credit + chunk, prompt_len)``) must
    reproduce the original schedule's suffix exactly.  Checking the
    k=1 boundary suffices by induction — the recomputed schedule is
    itself an instance of the same recurrence one chunk further along,
    so suffix equality at every boundary follows from equality at the
    first.  ``new_widths`` would list any resumed chunk width outside
    the whole-prompt enumeration (must be empty: resumed execution can
    then never trace a signature the warmup/proof missed)."""
    from repro_torch.serve.engine import prefill_schedule

    base_widths: Set[int] = set()
    resumed_widths: Set[int] = set()
    resume_points = 0
    suffix_exact = True
    for plen in range(1, max_len):
        starts: Sequence[int] = (0,)
        if prefix_cache and page_size:
            cap = ((plen - 1) // page_size) * page_size
            starts = range(0, cap + 1, page_size)
        for credit in starts:
            sched = prefill_schedule(plen, chunk=prefill_chunk,
                                     max_len=max_len, bucketed=bucketed,
                                     start=credit)
            base_widths.update(w for _s, w in sched)
            if len(sched) < 2:
                continue          # single-chunk schedules never resume
            pos1 = min(credit + prefill_chunk, plen)
            resumed = prefill_schedule(plen, chunk=prefill_chunk,
                                       max_len=max_len, bucketed=bucketed,
                                       start=pos1)
            resume_points += 1
            if resumed != sched[1:]:
                suffix_exact = False
            resumed_widths.update(w for _s, w in resumed)
    new = sorted(resumed_widths - base_widths)
    return {
        "resume_points": resume_points,
        "suffix_exact": suffix_exact,
        "new_widths": new,
        "closed": suffix_exact and not new,
    }


def retrace_budget(*, bucketed: bool, paged: bool, max_len: int,
                   prefill_chunk: int, page_size: Optional[int] = None,
                   pages_per_slot: Optional[int] = None,
                   prefix_cache: bool = True,
                   declared: Optional[int] = None) -> Dict[str, Any]:
    """Prove the engine's compile set finite and within budget.

    In the port a "compile" is one static step built for a bucket: a
    captured ``torch.cuda.CUDAGraph`` on the card, the same step object
    built (not captured) on the CPU.  The *declared* budget is the
    reference's design contract: ``log2(prefill_chunk)+1`` prefill
    buckets, ``log2(pages_per_slot rounded to pow2)+1`` decode table
    buckets (1 for contiguous), plus one pool-copy trace under paging.
    The *proven* counts come from exhaustive enumeration over every
    reachable input; an unbucketed family proves MORE signatures than
    declared and fails ``within_budget``.

    ``pool_copy`` keeps the reference's proven count (its donated,
    jitted copy-on-write page copy), so the dict equals the reference's
    key for key; the port's page copy is an eager in-place copy
    (``Engine._copy_page``) and captures no graph.
    """
    from repro_torch.serve.engine import _next_pow2

    prefill = enumerate_prefill_buckets(
        max_len=max_len, prefill_chunk=prefill_chunk, bucketed=bucketed,
        page_size=page_size if paged else None, prefix_cache=prefix_cache)
    declared_prefill = max(prefill_chunk.bit_length(), 1)
    if paged:
        assert page_size and pages_per_slot, "paged budget needs page geometry"
        decode = enumerate_decode_buckets(
            max_len=max_len, page_size=page_size,
            pages_per_slot=pages_per_slot)
        declared_decode = _next_pow2(pages_per_slot).bit_length()
        pool_copy = 1
    else:
        decode = []                     # one static full-width signature
        declared_decode = 1
        pool_copy = 0
    proven_decode = len(decode) if paged else 1
    proven_total = len(prefill) + proven_decode + pool_copy
    declared_total = (declared if declared is not None
                      else declared_prefill + declared_decode + pool_copy)
    resume = verify_chunk_resume(
        max_len=max_len, prefill_chunk=prefill_chunk, bucketed=bucketed,
        page_size=page_size if paged else None, prefix_cache=prefix_cache)
    return {
        "prefill": {"bucketed": bucketed, "buckets": prefill,
                    "proven": len(prefill), "declared": declared_prefill},
        "decode": {"paged": paged, "buckets": decode,
                   "proven": proven_decode, "declared": declared_decode},
        "pool_copy": {"proven": pool_copy, "declared": pool_copy},
        "chunk_resume": resume,
        "proven_total": proven_total,
        "declared_total": declared_total,
        "within_budget": (len(prefill) <= declared_prefill
                          and proven_decode <= declared_decode
                          and proven_total <= declared_total
                          and resume["closed"]),
    }


# --------------------------------------------------------------------------
# pass 2: host-sync audit (AST)
# --------------------------------------------------------------------------

#: method calls that read a device value back to the host (``.numpy()``
#: on a host tensor is host-only: tag such a site ``host``)
_D2H_METHODS = frozenset({"cpu", "item", "tolist", "numpy"})
_D2H_BUILTINS = frozenset({"int", "float", "bool"})
#: torch constructors that upload when given a ``device=``
_H2D_CONSTRUCTORS = frozenset({"as_tensor", "tensor"})

_SYNC_TAG_RE = re.compile(
    r"#\s*sync:\s*(required|eliminable|host)\b\s*[—–-]*\s*(.*)")

#: how often each tick-path function of the port's engine runs in
#: steady-state decode — the per-tick gate counts only funcs at "tick"
#: frequency (a function missing here counts as "tick")
_TICK_FREQ = {
    "step": "tick", "run_to_completion": "tick", "_flush_tables": "tick",
    "_decode_table_width": "tick", "_select": "tick", "_run_decode": "tick",
    "_decode_step_for": "tick", "_set_cursor": "tick",
    "decode_table_width": "tick",
    "_ensure_pages": "growth", "_reclaim_pages": "growth",
    "_run_prefills": "admission", "_advance_one": "admission",
    "_plan_chunks": "admission", "_batch_cost": "admission",
    "_reserve_chunks": "admission", "_stage_slot": "admission",
    "_exec_chunks": "admission", "_complete_admission": "admission",
    "_unwind_slot": "admission", "_prefix_credit": "admission",
    "_prefill_schedule": "admission", "_prefill_extent": "admission",
    "_prefill_step_for": "admission", "prefill_schedule": "admission",
    "_copy_page": "fork",
    "_finish": "finish", "_scrub_slot_device": "finish",
    "_append_token": "token",
    "_build_step": "bucket", "_capture": "bucket",
    "_kernel_provenance": "bucket", "retrace_budget": "stats",
    "_dump_on_error": "error", "_check_compile_soundness": "drain",
}


class SyncSite(NamedTuple):
    path: str
    line: int
    func: str        # enclosing tick-path function
    api: str         # e.g. ".tolist", "copy_(from_numpy)", "int()"
    kind: str        # "h2d" | "d2h"
    freq: str        # tick | admission | growth | fork | finish | token
    cls: str         # required | eliminable | host | "" (untagged)
    reason: str


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _device_target(node: ast.AST) -> Optional[str]:
    """"cpu", "device" or None for a ``.to(...)`` argument: a device
    string, ``torch.device(...)``, or a name / attribute that names a
    device (``device``, ``self.device``, ``q.device``, ``dev``)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        kind = node.value.split(":")[0]
        return kind if kind in ("cpu", "cuda") else None
    if isinstance(node, ast.Call) and _dotted(node.func) == "torch.device":
        if node.args and isinstance(node.args[0], ast.Constant):
            return _device_target(node.args[0])
        return "device"
    name = _dotted(node).rsplit(".", 1)[-1]
    if name == "dev" or name.endswith("device"):
        return "device"
    return None


def classify_sync_call(node: ast.AST) -> Optional[Tuple[str, str]]:
    """(api, kind) when the Call crosses the host<->device link through
    one of torch's transfer surfaces; None otherwise.

    h2d: ``.to(<device>)``, ``<tensor>.copy_(torch.from_numpy(...))``,
    ``torch.as_tensor`` / ``torch.tensor`` with ``device=``.  d2h:
    ``.cpu()``, ``.item()``, ``.tolist()``, ``.numpy()``, ``.to("cpu")``,
    ``int()`` / ``float()`` / ``bool()`` of a non-literal, and
    ``torch.cuda.synchronize()``."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute):
        base = _dotted(f.value)
        if f.attr == "to":
            targets = list(node.args[:1]) + [
                kw.value for kw in node.keywords if kw.arg == "device"]
            for t in targets:
                kind = _device_target(t)
                if kind == "cpu":
                    return ".to(cpu)", "d2h"
                if kind is not None:
                    return ".to(device)", "h2d"
            return None
        if f.attr == "copy_" and node.args and isinstance(
                node.args[0], ast.Call) and _dotted(
                    node.args[0].func) == "torch.from_numpy":
            return "copy_(from_numpy)", "h2d"
        if base == "torch" and f.attr in _H2D_CONSTRUCTORS and any(
                kw.arg == "device" for kw in node.keywords):
            return f"torch.{f.attr}(device=)", "h2d"
        if base == "torch.cuda" and f.attr == "synchronize":
            return "torch.cuda.synchronize", "d2h"
        if f.attr in _D2H_METHODS and base not in ("torch", "np", "numpy"):
            return f".{f.attr}", "d2h"
    if (isinstance(f, ast.Name) and f.id in _D2H_BUILTINS and node.args
            and not isinstance(node.args[0], ast.Constant)):
        return f"{f.id}()", "d2h"
    return None


def find_sync_tag(line: str) -> Optional[Tuple[str, str]]:
    """(class, reason) from a ``# sync:`` tag on one source line."""
    m = _SYNC_TAG_RE.search(line)
    return (m.group(1), m.group(2).strip()) if m else None


def tick_path_functions(tree: ast.Module,
                        roots: Sequence[str] = ("step", "run_to_completion"),
                        ) -> Set[str]:
    """Transitive closure of the engine call graph from the tick roots,
    over ``self.X()`` method calls and bare module-function calls."""
    defs: Dict[str, ast.FunctionDef] = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            defs[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    defs[item.name] = item

    def callees(fn: ast.FunctionDef) -> Set[str]:
        found: Set[str] = set()
        for n in ast.walk(fn):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self" and f.attr in defs):
                found.add(f.attr)
            elif isinstance(f, ast.Name) and f.id in defs:
                found.add(f.id)
        return found

    reached: Set[str] = set()
    frontier = [r for r in roots if r in defs]
    while frontier:
        name = frontier.pop()
        if name in reached:
            continue
        reached.add(name)
        frontier.extend(callees(defs[name]) - reached)
    return reached


def audit_sync_sites(src: str, path: str = "serve/engine.py",
                     roots: Sequence[str] = ("step", "run_to_completion"),
                     ) -> List[SyncSite]:
    """Inventory every host<->device sync call inside the tick-path
    call-graph closure of one module's source."""
    tree = ast.parse(src, filename=path)
    funcs = tick_path_functions(tree, roots)
    lines = src.splitlines()
    sites: List[SyncSite] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef) or node.name not in funcs:
            continue
        for call in ast.walk(node):
            hit = classify_sync_call(call)
            if hit is None:
                continue
            api, kind = hit
            tag = find_sync_tag(lines[call.lineno - 1]) \
                if call.lineno <= len(lines) else None
            cls, reason = tag if tag else ("", "")
            sites.append(SyncSite(
                path=path, line=call.lineno, func=node.name, api=api,
                kind=kind, freq=_TICK_FREQ.get(node.name, "tick"),
                cls=cls, reason=reason))
    sites.sort(key=lambda s: (s.line, s.api))
    return sites


#: per-decode-tick transfer contract: one batched table flush + one
#: last-token upload (h2d <= 2) and one next-token readback (d2h <= 1)
PER_TICK_DECLARED = {"h2d": 2, "d2h": 1}


def sync_summary(sites: Sequence[SyncSite],
                 declared: Optional[Dict[str, int]] = None
                 ) -> Dict[str, Any]:
    """Aggregate the inventory into the CI gate: untagged sites are
    violations; per-tick counts (freq == "tick", class != host) must
    stay within the declared contract (``declared`` overrides the
    engine's 2 h2d + 1 d2h — the telemetry audit declares 0 + 0)."""
    if declared is None:
        declared = PER_TICK_DECLARED
    untagged = [s for s in sites if not s.cls]
    per_tick = {
        "h2d": sum(1 for s in sites
                   if s.freq == "tick" and s.kind == "h2d"
                   and s.cls != "host"),
        "d2h": sum(1 for s in sites
                   if s.freq == "tick" and s.kind == "d2h"
                   and s.cls != "host"),
    }
    table_flushes = sum(1 for s in sites
                        if s.func == "_flush_tables" and s.kind == "h2d")
    return {
        "sites": [s._asdict() for s in sites],
        "n_sites": len(sites),
        "unallowlisted": [s._asdict() for s in untagged],
        "eliminable": [s._asdict() for s in sites
                       if s.cls == "eliminable"],
        "per_tick": per_tick,
        "declared_per_tick": dict(declared),
        "block_table_uploads_per_tick": table_flushes,
        "ok": (not untagged
               and per_tick["h2d"] <= declared["h2d"]
               and per_tick["d2h"] <= declared["d2h"]
               and table_flushes <= 1),
    }


def _rel(path) -> str:
    rel = str(path).replace("\\", "/")
    return rel[rel.rfind("repro_torch/"):] if "repro_torch/" in rel else rel


def audit_engine_file(path: Optional[str] = None) -> Dict[str, Any]:
    """Run the sync audit on the installed ``repro_torch.serve.engine``."""
    if path is None:
        import repro_torch.serve.engine as engine_mod
        path = engine_mod.__file__
    src = Path(path).read_text(encoding="utf-8")
    return sync_summary(audit_sync_sites(src, _rel(path)))


#: the telemetry emit path: every Tracer/Histogram/MetricsRegistry
#: method the engine may call per tick / per event while serving.  The
#: audit closes the call graph from these roots over serve/telemetry.py
#: — export/validation/CLI code is deliberately outside (it runs when a
#: trace is written, not while serving).
TELEMETRY_SYNC_ROOTS = (
    "_emit", "now", "begin", "end", "instant", "complete", "counter",
    "set_meta", "set_thread_name", "request_submit", "request_admitted",
    "request_chunks", "request_paused", "request_resumed",
    "request_restaged", "request_decode", "request_finish",
    "request_cancel", "record", "histogram",
)

#: instrumentation must be transfer-free: the telemetry emit path may
#: perform ZERO host<->device syncs
TELEMETRY_PER_TICK_DECLARED = {"h2d": 0, "d2h": 0}


def audit_telemetry_file(path: Optional[str] = None) -> Dict[str, Any]:
    """Host-sync audit of ``repro_torch.serve.telemetry``'s emit path:
    the instrumentation the engine calls while serving performs no
    host<->device transfer (declared 0 h2d + 0 d2h; host-tagged sites —
    python-float coercions of host scalars — are inventoried but
    excluded, as in the engine audit)."""
    if path is None:
        import repro_torch.serve.telemetry as tel_mod
        path = tel_mod.__file__
    src = Path(path).read_text(encoding="utf-8")
    sites = audit_sync_sites(src, _rel(path), roots=TELEMETRY_SYNC_ROOTS)
    return sync_summary(sites, declared=TELEMETRY_PER_TICK_DECLARED)
