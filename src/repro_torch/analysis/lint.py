"""Lane-discipline lint: AST checks for the port's cross-lane invariants.

Port of :mod:`repro.analysis.lint`, reading ``torch.`` where the
reference reads ``jnp.``.  Four rules, each guarding a bug class the
codebase has actually hit or is structurally exposed to:

LANE001  no direct ``np.``/``numpy.``/``torch.`` *arithmetic* at the top
         level of a lane-generic function (any function with a parameter
         literally named ``lane``).  Handles must route through the Lane
         protocol: a raw ``torch.add`` on a handle silently runs
         float/int32 math on the fhe_sim lane's int64 tensors with **no
         cost accounting and no width observation**, breaking int≡fhe
         parity and making every measured/static report a lie.  Nested ``def``/``lambda`` bodies
         are exempt — LUT table functions are legitimately numpy (they
         *define* the table a PBS evaluates; they are not handle math).

LANE002  no ``lane.mul`` / ``lane.dot_scores`` / ``lane.mix_values``
         inside a lane-generic function whose name contains
         ``inhibitor``.  The inhibitor family's zero-cmul property is the
         paper's headline claim; a cipher×cipher op reachable from its
         lane code would forfeit it.  (The static analyzer proves the
         runtime claim; this rule catches the edit at review time, before
         anything runs.)

LANE003  no bare ``hash()`` anywhere: Python's string hashing is salted
         per process (PYTHONHASHSEED), so seed/key derivation through it
         is nondeterministic across runs.  Derive integers with
         ``zlib.crc32``/``hashlib`` instead.

LANE004  no untagged host-sync primitive (``.item()``, ``.cpu()``,
         ``.tolist()``, ``int()``/``float()`` coercion, ``.to(device)``
         and ``copy_(torch.from_numpy(...))`` uploads) inside the
         tick-path functions of ``serve/engine.py`` or the telemetry
         emit path of ``serve/telemetry.py``.  Every sync these paths
         keep must carry a ``# sync: <required|eliminable|host> —
         <reason>`` tag on its line — the serve-path analyzer
         (``repro_torch.analysis.serve_static``, whose classifier this
         rule shares) audits the tagged inventory
         and CI gates on the per-tick counts, so a new sync can't land
         silently.  The tick path is the static call-graph closure of
         ``Engine.step`` / ``run_to_completion``; the telemetry emit
         path is the closure of the Tracer/Histogram hooks the engine
         may call per tick (``TELEMETRY_SYNC_ROOTS``), whose declared
         contract is zero h2d + zero d2h.

Run as ``python -m repro_torch.analysis.lint [paths...]`` (default: the
``repro_torch`` package); exits non-zero listing every violation.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterator, List, NamedTuple

#: np/torch attribute calls that are handle arithmetic when applied at the
#: top level of a lane-generic function (structural helpers like asarray/
#: shape/arange/broadcast_to are deliberately absent: cleartext weights,
#: masks and literals are legitimately numpy); the reference's numpy
#: names plus torch's own spellings (mul, sub, div, clamp, mm, ...)
_ARITH_ATTRS = frozenset({
    "add", "subtract", "multiply", "divide", "true_divide", "floor_divide",
    "matmul", "dot", "einsum", "tensordot", "inner", "outer",
    "sum", "prod", "cumsum", "mean", "max", "min", "amax", "amin",
    "maximum", "minimum", "abs", "absolute", "clip", "where", "negative",
    "exp", "exp2", "log", "log2", "sqrt", "square", "sign", "tanh",
    "right_shift", "left_shift", "round", "rint", "power", "reciprocal",
    "softmax", "relu",
    "mul", "sub", "div", "clamp", "mm", "bmm", "remainder", "neg",
})

_CMUL_METHODS = frozenset({"mul", "dot_scores", "mix_values"})

_ARRAY_MODULES = frozenset({"np", "numpy", "torch"})

#: the lint's default target: this package
_PACKAGE = Path(__file__).resolve().parents[1]


class Violation(NamedTuple):
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _is_lane_generic(fn: ast.AST) -> bool:
    """A function is lane-generic iff it takes a parameter named ``lane``
    (the repo-wide convention for Lane-protocol code)."""
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return False
    a = fn.args
    names = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
    return "lane" in names


def _top_level_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body without descending into nested functions or
    lambdas (their bodies are table definitions, not handle math)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression (``jax.numpy`` etc.)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _check_function(fn, path: str, out: List[Violation]) -> None:
    lane_generic = _is_lane_generic(fn)
    inhibitor_scope = lane_generic and "inhibitor" in fn.name
    if not lane_generic:
        return
    for node in _top_level_nodes(fn):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        base = _dotted(node.func.value)
        attr = node.func.attr
        if base in _ARRAY_MODULES and attr in _ARITH_ATTRS:
            out.append(Violation(
                path, node.lineno, "LANE001",
                f"direct {base}.{attr}() at the top level of lane-generic "
                f"{fn.name}(); route handle arithmetic through the Lane "
                "protocol (nested table fns are exempt)"))
        if inhibitor_scope and base == "lane" and attr in _CMUL_METHODS:
            out.append(Violation(
                path, node.lineno, "LANE002",
                f"lane.{attr}() inside inhibitor-family {fn.name}() — a "
                "cipher×cipher op would forfeit the proven zero-cmul "
                "property"))


def _check_sync_discipline(tree: ast.Module, src: str, path: str,
                           out: List[Violation]) -> None:
    """LANE004: tick-path host-sync sites in serve/engine.py — and the
    telemetry emit path in serve/telemetry.py — must carry a
    ``# sync:`` tag (classification + tag grammar live in serve_static,
    shared with the analyzer so the lint and the audit can never
    disagree about what counts as a sync)."""
    norm = path.replace("\\", "/")
    from repro_torch.analysis.serve_static import (TELEMETRY_SYNC_ROOTS,
                                                   classify_sync_call,
                                                   find_sync_tag,
                                                   tick_path_functions)

    if norm.endswith("serve/engine.py"):
        funcs = tick_path_functions(tree)
    elif norm.endswith("serve/telemetry.py"):
        funcs = tick_path_functions(tree, roots=TELEMETRY_SYNC_ROOTS)
    else:
        return
    lines = src.splitlines()
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef) or node.name not in funcs:
            continue
        for call in ast.walk(node):
            hit = classify_sync_call(call)
            if hit is None:
                continue
            api, kind = hit
            line = lines[call.lineno - 1] if call.lineno <= len(lines) else ""
            if find_sync_tag(line) is None:
                out.append(Violation(
                    path, call.lineno, "LANE004",
                    f"untagged host-sync {api} ({kind}) in tick-path "
                    f"{node.name}(); add '# sync: <required|eliminable|"
                    f"host> — <reason>' on this line or move the sync "
                    "off the tick path"))


def lint_source(src: str, path: str = "<string>") -> List[Violation]:
    """Lint one module's source; returns violations (possibly empty)."""
    out: List[Violation] = []
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 0, "LANE000",
                          f"syntax error: {e.msg}")]
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _check_function(node, path, out)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "hash"):
            out.append(Violation(
                path, node.lineno, "LANE003",
                "bare hash() — salted per process (PYTHONHASHSEED); use "
                "zlib.crc32/hashlib for seed- or key-derived values"))
    _check_sync_discipline(tree, src, path, out)
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def lint_paths(paths) -> List[Violation]:
    """Lint every ``*.py`` under the given files/directories."""
    out: List[Violation] = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            out.extend(lint_source(f.read_text(encoding="utf-8"), str(f)))
    return out


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    paths = args or [str(_PACKAGE)]
    violations = lint_paths(paths)
    for v in violations:
        print(v)
    n_files = sum(len(sorted(Path(p).rglob("*.py"))) if Path(p).is_dir()
                  else 1 for p in paths)
    if violations:
        print(f"lane-discipline lint: {len(violations)} violation(s) in "
              f"{n_files} file(s)", file=sys.stderr)
        return 1
    print(f"lane-discipline lint: clean ({n_files} file(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
