"""Static analysis of the port's serving hot path.

Port of :mod:`repro.analysis.serve_static`, its three passes over the
engine's static steps and the tick path's host code:

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
   dirty; 1 without a block table, as for the recurrent family) and 1
   d2h (the next tokens); the telemetry emit path makes none
   (:func:`audit_telemetry_file`).

3. **Static roofline** — :func:`roofline_engine` walks each enumerated
   decode and prefill step's body with :mod:`repro_torch.analysis.
   costmodel` (aten operations on ``meta`` tensors) and reports FLOPs /
   HBM-byte / transfer-byte budgets per tick and the host syncs inside
   the steps.  :func:`verify_engine_signatures` builds the same bodies
   on ``meta`` tensors (the reference's ``jax.eval_shape``: no device
   work), proving each enumerated signature constructible;
   :func:`cross_check_bench` holds measured step counts against the
   proven bound re-derived from a recorded :func:`engine_desc`.

On ``meta`` the planner plans the plain path (no kernel is native
there), so the walk charges the plain version where the card launches
a kernel; the roofline records which backend it walked.

Entry point: ``python -m repro_torch.analysis.serve`` (``serve.py``),
writing ``ANALYSIS_serve.json``.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

SCHEMA_VERSION = 2

__all__ = [
    "retrace_budget", "enumerate_prefill_buckets",
    "enumerate_decode_buckets", "verify_chunk_resume",
    "verify_engine_signatures",
    "audit_sync_sites", "sync_summary", "tick_path_functions",
    "classify_sync_call", "find_sync_tag", "audit_engine_file",
    "audit_telemetry_file", "TELEMETRY_SYNC_ROOTS", "PER_TICK_DECLARED",
    "roofline_engine", "engine_desc", "analyze_serve", "cross_check_bench",
    "format_serve_report",
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


def _signature(*trees) -> str:
    """Stable digest of the shapes and dtypes of every tensor in trees."""
    import hashlib

    from repro_torch.analysis.costmodel import _tensors

    leaves = [(tuple(t.shape), str(t.dtype)) for t in _tensors(trees)]
    return hashlib.sha256(repr(leaves).encode()).hexdigest()[:16]


def _meta_twin(engine):
    """A shallow copy of ``engine`` whose parameters and state are
    ``meta`` tensors of the same shapes and dtypes, with no static step
    built: its steps' bodies run without data or a card (the planner
    plans the plain path on ``meta``), and the engine is untouched."""
    import copy

    import torch

    from repro_torch.analysis.costmodel import to_meta

    twin = copy.copy(engine)
    twin.params = to_meta(engine.params)
    twin.states = to_meta(engine.states)
    twin.device = torch.device("meta")
    twin._decode_steps, twin._prefill_steps = {}, {}
    twin._graph_pool = None
    return twin


def _decode_backend(engine) -> str:
    """The decode tick's backend as ``engine`` plans it on its device:
    the attention plan's, or the WKV plan's for the recurrent family
    (its decode carries a state: the exact scan)."""
    if engine.decode_plan is not None:
        return engine.decode_plan.backend
    from repro_torch.models.rwkv import wkv_plan

    return wkv_plan(use_kernel=False, carried_state=True).backend


def _decode_widths(engine, budget: Dict[str, Any]) -> List[Any]:
    return (list(budget["decode"]["buckets"]) if engine.paged
            else ["contiguous"])


def verify_engine_signatures(engine, budget: Dict[str, Any]
                             ) -> Dict[str, Any]:
    """Build every enumerated static step against a live engine and run
    its body on ``meta`` tensors (the reference's ``jax.eval_shape``: no
    compilation, no device work), proving each signature constructible
    and recording a digest of its inputs' shapes and dtypes.  An
    untraceable signature is a finding (``verified: False`` with the
    error), not a crash."""
    out: Dict[str, Any] = {"prefill": [], "decode": [], "verified": True}
    try:
        twin = _meta_twin(engine)
        for cb in budget["prefill"]["buckets"]:
            step = twin._build_step("prefill", cb)
            step.body()
            out["prefill"].append({
                "width": cb, "signature": _signature(
                    twin.params, step.tokens, step.cursor, step.table,
                    step.slot, twin.states),
                "out_shape": list(step.out.shape)})
        for hw in _decode_widths(engine, budget):
            step = twin._build_step("decode", hw)
            step.body()
            # the step reads the block tables clamped to its width
            tables = (twin.states.kv.block_tables[:, :hw]
                      if engine.paged else None)
            out["decode"].append({
                "table_width": hw if engine.paged else None,
                "signature": _signature(twin.params, step.tokens,
                                        twin.states, tables),
                "out_shape": list(step.out.shape)})
    except Exception as e:  # noqa: BLE001 — an untraceable signature is
        out["verified"] = False       # a finding, not an analyzer crash
        out["error"] = f"{type(e).__name__}: {e}"
    return out


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
    "decode_table_width": "tick", "_prefill_quota": "tick",
    "_ensure_pages": "growth", "_reclaim_pages": "growth",
    "_run_prefills": "admission", "_advance_one": "admission",
    "_plan_chunks": "admission", "_batch_cost": "admission",
    "_reserve_chunks": "admission", "_stage_slot": "admission",
    "_exec_chunks": "admission", "_complete_admission": "admission",
    "_unwind_slot": "admission", "_prefix_credit": "admission",
    "_prefill_schedule": "admission", "_prefill_extent": "admission",
    "_prefill_step_for": "admission", "prefill_schedule": "admission",
    "_reset_slot": "admission",
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
    "_emit", "now", "begin", "end", "instant", "complete", "set_meta",
    "set_thread_name", "request_submit", "request_admitted",
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


# --------------------------------------------------------------------------
# pass 3: static roofline
# --------------------------------------------------------------------------

def roofline_engine(engine, budget: Dict[str, Any],
                    platform=None) -> Dict[str, Any]:
    """Per-bucket FLOPs / HBM bytes / transfer bytes of the engine's
    static steps, by walking each step's body on ``meta`` tensors
    (:func:`repro_torch.analysis.costmodel.torch_costs`), plus the
    per-tick host<->device transfer budget: the token batch in and the
    block tables when paged (2 h2d, else 1), the next tokens out (1
    d2h).  ``jit_host_callbacks`` counts the host syncs inside the
    steps; ``walked`` says which decode backend the walk ran (the plain
    path on ``meta``) beside the one the engine runs."""
    from repro_torch.analysis import costmodel

    platform = platform or costmodel.DEFAULT_PLATFORM
    b, itemsize = engine.cfg.max_batch, 4
    per_tick_h2d = b * itemsize                    # the token batch
    if engine.paged:
        per_tick_h2d += b * engine.alloc.pages_per_slot * itemsize
    per_tick_d2h = b * itemsize                    # the next tokens
    twin = _meta_twin(engine)
    twin.decode_plan = twin._plan_decode()
    out: Dict[str, Any] = {
        "platform": platform.name,
        "walked": {"device": "meta",
                   "decode_backend": _decode_backend(twin),
                   "engine_decode_backend": _decode_backend(engine)},
        "transfers_per_tick": {
            "h2d_bytes": per_tick_h2d, "d2h_bytes": per_tick_d2h,
            "h2d_ops": 2 if engine.paged else 1, "d2h_ops": 1},
        "decode": {"per_bucket": {}}, "prefill": {"per_bucket": {}},
    }
    transfer = float(per_tick_h2d + per_tick_d2h)
    decode_entries = {}
    for hw in _decode_widths(engine, budget):
        step = twin._build_step("decode", hw)
        costs = costmodel.torch_costs(step.body)
        decode_entries[str(hw if engine.paged else "full")] = \
            costmodel.roofline(costs, platform, transfer_bytes=transfer)
    out["decode"]["per_bucket"] = decode_entries
    if decode_entries:
        out["decode"]["max"] = max(decode_entries.values(),
                                   key=lambda e: e["hbm_bytes"])
    prefill_entries = {}
    for cb in budget["prefill"]["buckets"]:
        step = twin._build_step("prefill", cb)
        prefill_entries[str(cb)] = costmodel.roofline(
            costmodel.torch_costs(step.body), platform,
            transfer_bytes=float(cb * itemsize))
    out["prefill"]["per_bucket"] = prefill_entries
    if prefill_entries:
        out["prefill"]["max"] = max(prefill_entries.values(),
                                    key=lambda e: e["hbm_bytes"])
    out["jit_host_callbacks"] = sum(
        e["host_callbacks"] for e in
        list(decode_entries.values()) + list(prefill_entries.values()))
    return out


# --------------------------------------------------------------------------
# report assembly + measured-vs-proven cross-check
# --------------------------------------------------------------------------

def engine_desc(engine) -> Dict[str, Any]:
    """The effective (post-clamp) engine configuration: what a bench
    artifact records so :func:`cross_check_bench` can re-derive the
    proven budget from the artifact alone (the reference's keys)."""
    return {
        "family": engine.api.cfg.family,
        "allocator": "paged" if engine.paged else "contiguous",
        "bucketed": engine._bucketed,
        "max_batch": engine.cfg.max_batch,
        "max_len": engine.cfg.max_len,
        "page_size": engine.cfg.page_size,
        "prefill_chunk": engine.cfg.prefill_chunk,
        "pages_per_slot": (engine.alloc.pages_per_slot
                           if engine.paged else None),
        "prefix_cache": engine.prefix is not None,
        # the token budget changes when chunks run, never their widths
        # (verify_chunk_resume); warm-up builds no step outside the proof
        "tick_budget": engine.cfg.tick_budget,
        "warmup": engine.cfg.warmup,
    }


def analyze_serve(config_name: str, *,
                  allocators: Sequence[str] = ("paged", "contiguous"),
                  engine_kw: Optional[Dict[str, Any]] = None,
                  reduced: Optional[Dict[str, Any]] = None,
                  declared_budget: Optional[int] = None,
                  seed: int = 0) -> Dict[str, Any]:
    """Run the three passes for one model config; returns the
    ``ANALYSIS_serve.json`` document (plain data, JSON-serialisable).

    The engine is built on the host from the seeded parameters of the
    port's own init: the analysis reads its configuration and walks its
    steps on ``meta`` tensors, so no pass does device work."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import Engine, EngineConfig

    cfg = get_config(config_name.replace("_", "-"))
    if reduced is not None:
        cfg = cfg.reduced(**reduced)
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(seed), device="cpu")
    engine_kw = dict(engine_kw or {})

    doc: Dict[str, Any] = {
        "schema": SCHEMA_VERSION,
        "config": cfg.name,
        "family": cfg.family,
        "engine_kw": engine_kw,
        "allocators": {},
    }
    ok = True
    for alloc in allocators:
        eng = Engine(api, params, EngineConfig(allocator=alloc, **engine_kw),
                     device="cpu")
        budget = retrace_budget(
            bucketed=eng._bucketed, paged=eng.paged,
            max_len=eng.cfg.max_len, prefill_chunk=eng.cfg.prefill_chunk,
            page_size=eng.cfg.page_size,
            pages_per_slot=eng.alloc.pages_per_slot if eng.paged else None,
            prefix_cache=eng.prefix is not None, declared=declared_budget)
        sigs = verify_engine_signatures(eng, budget)
        roof = roofline_engine(eng, budget)
        arm_ok = (budget["within_budget"] and sigs["verified"]
                  and roof["jit_host_callbacks"] == 0)
        doc["allocators"][alloc] = {
            "engine": engine_desc(eng),
            "retrace": budget,
            "signatures": sigs,
            "roofline": roof,
            "ok": arm_ok,
        }
        ok = ok and arm_ok
    audit = audit_engine_file()
    doc["sync_audit"] = audit
    # the telemetry emit path is audited under its own contract: the
    # instrumentation adds no h2d / d2h to the tick
    audit_tel = audit_telemetry_file()
    doc["sync_audit_telemetry"] = audit_tel
    doc["ok"] = ok and audit["ok"] and audit_tel["ok"]
    return doc


def cross_check_bench(bench_doc: Dict[str, Any]) -> Dict[str, Any]:
    """Measured-vs-proven step counts over a bench artifact: each arm
    records its effective engine config (``engine``, from
    :func:`engine_desc`) and its live ``prefill_compiles`` /
    ``decode_compiles``; the proven budget is re-derived from the
    recorded config alone.  A measured count above the proven bound
    means the enumeration missed a reachable step: a SOUNDNESS BUG,
    reported loudly."""
    arms: Dict[str, Any] = {}
    ok = True
    for name, arm in bench_doc.items():
        if not isinstance(arm, dict) or "engine" not in arm:
            continue
        e = arm["engine"]
        budget = retrace_budget(
            bucketed=e["bucketed"], paged=e["allocator"] == "paged",
            max_len=e["max_len"], prefill_chunk=e["prefill_chunk"],
            page_size=e["page_size"], pages_per_slot=e.get("pages_per_slot"),
            prefix_cache=e.get("prefix_cache", False))
        checks = {
            "prefill": {"measured": arm.get("prefill_compiles", 0),
                        "proven": budget["prefill"]["proven"]},
            "decode": {"measured": arm.get("decode_compiles", 0),
                       "proven": budget["decode"]["proven"]},
        }
        failures = [
            f"SOUNDNESS BUG: {name}.{k} measured {v['measured']} compiles "
            f"> proven bound {v['proven']} — the static enumeration "
            f"missed a reachable trace signature"
            for k, v in checks.items() if v["measured"] > v["proven"]]
        arms[name] = {"checks": checks, "failures": failures,
                      "ok": not failures}
        ok = ok and not failures
    return {"ok": ok, "arms": arms, "checked": sorted(arms)}


def format_serve_report(doc: Dict[str, Any]) -> str:
    """Human-readable summary of an :func:`analyze_serve` document."""
    lines = [f"serve static analysis: config={doc['config']} "
             f"family={doc['family']}"]
    for alloc, arm in doc["allocators"].items():
        r = arm["retrace"]
        lines.append(
            f"  [{alloc}] compile set: prefill {r['prefill']['proven']}"
            f"/{r['prefill']['declared']} buckets "
            f"{r['prefill']['buckets']}, decode {r['decode']['proven']}"
            f"/{r['decode']['declared']} "
            f"({'within' if r['within_budget'] else 'OVER'} budget, "
            f"total {r['proven_total']}/{r['declared_total']})")
        cr = r.get("chunk_resume")
        if cr:
            lines.append(
                f"  [{alloc}] chunk resume: {cr['resume_points']} resume "
                f"points, suffix "
                f"{'exact' if cr['suffix_exact'] else 'MISMATCH'}, "
                f"new widths {cr['new_widths']} -> "
                f"{'closed' if cr['closed'] else 'OPEN'}")
        roof = arm["roofline"]
        dmax = roof["decode"].get("max")
        if dmax:
            lines.append(
                f"  [{alloc}] decode tick (widest bucket, walked "
                f"{roof['walked']['decode_backend']} on meta): "
                f"{dmax['flops']:.3g} FLOPs, {dmax['hbm_bytes']:.3g} "
                f"HBM bytes, bound={dmax['bound']}, "
                f"est {dmax['est_s'] * 1e6:.1f} us")
        t = roof["transfers_per_tick"]
        lines.append(
            f"  [{alloc}] transfers/tick: {t['h2d_ops']} h2d "
            f"({t['h2d_bytes']} B), {t['d2h_ops']} d2h "
            f"({t['d2h_bytes']} B)")
    audit = doc["sync_audit"]
    lines.append(
        f"  sync audit: {audit['n_sites']} sites, "
        f"{len(audit['unallowlisted'])} untagged, per-tick "
        f"h2d={audit['per_tick']['h2d']}/"
        f"{audit['declared_per_tick']['h2d']} "
        f"d2h={audit['per_tick']['d2h']}/"
        f"{audit['declared_per_tick']['d2h']}, "
        f"table uploads/tick={audit['block_table_uploads_per_tick']}")
    tel = doc.get("sync_audit_telemetry")
    if tel:
        lines.append(
            f"  telemetry audit: {tel['n_sites']} sites, "
            f"{len(tel['unallowlisted'])} untagged, emit-path "
            f"h2d={tel['per_tick']['h2d']}/"
            f"{tel['declared_per_tick']['h2d']} "
            f"d2h={tel['per_tick']['d2h']}/"
            f"{tel['declared_per_tick']['d2h']} "
            f"({'transfer-free' if tel['ok'] else 'VIOLATED'})")
    if "cross_check" in doc:
        cc = doc["cross_check"]
        lines.append(f"  bench cross-check: arms={cc['checked']} "
                     f"{'OK' if cc['ok'] else 'FAILED'}")
        for arm in cc["arms"].values():
            lines.extend(f"    {f}" for f in arm["failures"])
    lines.append(f"  => {'OK' if doc['ok'] else 'FAILED'}")
    return "\n".join(lines)
