"""The port's AST lint (the torch meaning of ``repro.analysis.lint``): the
JAX package's rule ids, CLI flags and suppression syntax, no new
dependencies. Run as::

    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch \\
        --max-suppressions 0                                    # gate
    PYTHONPATH=src python -m repro_torch.analysis.lint tests/ --report-only

A *traced function* is one whose body must stay capturable as a CUDA graph
or compiled whole: a trip function (a name in
:data:`repro_torch.analysis.audit.TRIP_FUNCTIONS`: ``fused_trip``,
``chain_trip``), any function passed to ``run_loop``
(``core/frontier.py``), ``torch.cuda.graph``,
``torch.cuda.make_graphed_callables`` or ``torch.compile`` (or decorated
with ``torch.compile``), the body of a ``with torch.cuda.graph(...)``
block, and anything nested in one of those. It is the static twin of the
audit's run-time rule that no host read happens inside a trip
(``analysis/audit.py``, ``hlo-host-sync``).

Rules
-----
``prng-aliasing``
    ``manual_seed(seed + x)`` (``torch.manual_seed``, a ``Generator``'s,
    ``torch.cuda.manual_seed``) with a non-constant arithmetic argument:
    nearby seeds alias streams across engines and tests. Derive the seed
    from (seed, x) with a hash (``numpy.random.SeedSequence``) or draw
    both streams from one generator.
``traced-truthiness``
    ``if`` / ``while`` / ``assert`` / ternary on a tensor expression (a
    ``torch.*`` call or a tensor method such as ``.any()``) inside a
    traced function: each is a host read that waits for the device.
``traced-cast``
    ``float()`` / ``int()`` / ``bool()`` of a tensor expression, or
    ``.item()``, inside a traced function.
``host-sync-in-trace``
    ``.cpu()``, ``.tolist()``, ``.numpy()``, ``np.asarray`` / ``np.array``,
    ``torch.cuda.synchronize()`` or ``Event.synchronize()`` inside a traced
    function.
``time-in-trace``
    ``time.time()`` / ``perf_counter()`` / ``monotonic()`` inside a traced
    function: a captured graph replays the value it read once.
``kernel-assert``
    A bare ``assert`` in ``kernels/``: stripped under ``python -O``. Raise
    ``ValueError`` at the host entry point instead.
``mutable-default``
    A mutable default argument (list / dict / set literal or constructor).
``lockset``
    From :mod:`repro_torch.analysis.locks`: a thread-shared attribute with
    no declared guard (files declaring ``THREAD_ENTRY_POINTS``).

Suppression: append ``# repro: noqa-<rule>`` to the offending line. The
gate counts suppressions: it runs with ``--max-suppressions 0`` and the
committed, empty baseline ``analysis/lint_baseline.txt``.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.audit import TRIP_FUNCTIONS

RULES = {
    "prng-aliasing": "manual_seed(seed + x) aliases streams",
    "traced-truthiness": "Python truthiness on a tensor in a trip",
    "traced-cast": "float()/int()/bool()/.item() of a tensor in a trip",
    "host-sync-in-trace": ".cpu()/.tolist()/.numpy()/synchronize in a trip",
    "time-in-trace": "wall-clock read in a trip",
    "kernel-assert": "bare assert in kernels/ (raise ValueError)",
    "mutable-default": "mutable default argument",
    "lockset": "thread-shared attribute without a declared guard",
}

NOQA = "# repro: noqa-"
PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "lint_baseline.txt")

# torch functions that return Python values, not tensors.
_HOST_SAFE = {"is_tensor", "is_floating_point", "is_complex", "device",
              "dtype", "finfo", "iinfo", "get_default_dtype",
              "is_grad_enabled", "promote_types", "result_type", "can_cast",
              "Size", "Generator", "no_grad", "enable_grad",
              "inference_mode", "is_available", "device_count",
              "current_device", "get_device_name"}
# Tensor methods whose result is a tensor a Python test would read.
_TENSOR_METHODS = {"any", "all", "sum", "max", "min", "amax", "amin", "mean",
                   "prod", "eq", "ne", "gt", "ge", "lt", "le", "isfinite",
                   "isnan", "isinf", "nonzero", "count_nonzero", "argmax",
                   "argmin", "norm", "equal", "allclose", "logical_and",
                   "logical_or", "logical_not"}
_HOST_SYNC_METHODS = {"cpu", "tolist", "numpy", "synchronize"}


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str
    line: int
    rule: str
    msg: str
    suppressed: bool = False

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}: [{self.rule}]{tag} {self.msg}"


def _chain(node: ast.AST) -> Tuple[str, ...]:
    """Dotted-name chain of an expression: torch.cuda.graph -> (torch,
    cuda, graph); '?' where the root is not a name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    parts.append(node.id if isinstance(node, ast.Name) else "?")
    return tuple(reversed(parts))


def _is_tensor_expr(node: ast.AST) -> bool:
    """A call that returns a tensor: rooted at ``torch`` / ``F`` (not a
    host-safe query, not under ``torch.cuda`` / ``torch.backends``), or a
    tensor method in ``_TENSOR_METHODS``."""
    if not isinstance(node, ast.Call):
        return False
    c = _chain(node.func)
    if c[-1] in _HOST_SAFE:
        return False
    if c[0] in ("torch", "F"):
        return not (len(c) > 2 and c[1] in ("cuda", "backends"))
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in _TENSOR_METHODS)


def _is_tracer(c: Tuple[str, ...]) -> bool:
    """Callees whose function-valued arguments are traced."""
    return (c[-1] in ("run_loop", "make_graphed_callables")
            or c[-2:] in (("cuda", "graph"), ("torch", "compile")))


def _set_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._repro_parent = node  # type: ignore[attr-defined]


_FUNC = (ast.FunctionDef, ast.AsyncFunctionDef)


def _name(region: ast.AST) -> str:
    if isinstance(region, _FUNC):
        return region.name
    return "<lambda>" if isinstance(region, ast.Lambda) else "<graph>"


def _collect_traced(tree: ast.Module) -> List[ast.AST]:
    """The traced regions: FunctionDef / Lambda nodes whose bodies run in a
    trip or a capture, and ``with torch.cuda.graph(...)`` blocks (see the
    module docstring)."""
    defs_by_scope: Dict[Optional[ast.AST], Dict[str, ast.AST]] = {}
    scope_of: Dict[ast.AST, Optional[ast.AST]] = {}

    def walk(node: ast.AST, scope: Optional[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNC):
                defs_by_scope.setdefault(scope, {})[child.name] = child
                scope_of[child] = scope
                walk(child, child)
            else:
                walk(child, scope)

    walk(tree, None)

    def resolve(name: str, scope: Optional[ast.AST]) -> Optional[ast.AST]:
        while True:
            fn = defs_by_scope.get(scope, {}).get(name)
            if fn is not None or scope is None:
                return fn
            scope = scope_of.get(scope)

    traced: Dict[ast.AST, None] = {}

    def mark(region: ast.AST) -> None:
        if region in traced:
            return
        traced[region] = None
        for child in ast.walk(region):          # nested defs trace too
            if isinstance(child, _FUNC + (ast.Lambda,)):
                traced.setdefault(child, None)

    for fn in scope_of:
        if fn.name in TRIP_FUNCTIONS:
            mark(fn)
        for dec in fn.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if _chain(target)[-2:] == ("torch", "compile"):
                mark(fn)

    for node in ast.walk(tree):
        if isinstance(node, ast.With) and any(
                isinstance(it.context_expr, ast.Call)
                and _chain(it.context_expr.func)[-2:] == ("cuda", "graph")
                for it in node.items):
            mark(node)
        if not (isinstance(node, ast.Call) and _is_tracer(_chain(node.func))):
            continue
        enclosing = node
        while enclosing is not None and not isinstance(enclosing, _FUNC):
            enclosing = getattr(enclosing, "_repro_parent", None)
        args = list(node.args) + [kw.value for kw in node.keywords]
        for arg in args:
            for item in (arg.elts if isinstance(arg, (ast.Tuple, ast.List))
                         else [arg]):
                if isinstance(item, ast.Lambda):
                    mark(item)
                elif isinstance(item, ast.Name):
                    fn = resolve(item.id, enclosing)
                    if fn is not None:
                        mark(fn)
    return list(traced)


def _prng_violations(tree: ast.Module, path: str) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        if _chain(node.func)[-1] != "manual_seed":
            continue
        arg = node.args[0]
        if isinstance(arg, ast.BinOp) and any(
                isinstance(leaf, (ast.Name, ast.Attribute, ast.Call))
                for leaf in ast.walk(arg)):
            out.append(Violation(
                path, node.lineno, "prng-aliasing",
                "manual_seed(seed + x) aliases streams across nearby seeds; "
                "derive the seed from (seed, x) with a hash "
                "(numpy.random.SeedSequence)"))
    return out


def _mutable_default_violations(tree: ast.Module,
                                path: str) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, _FUNC):
            continue
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            mutable = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
                and d.func.id in ("list", "dict", "set"))
            if mutable:
                out.append(Violation(
                    path, d.lineno, "mutable-default",
                    f"mutable default argument in {node.name}(); "
                    "default to None and build inside"))
    return out


def _kernel_assert_violations(tree: ast.Module,
                              path: str) -> List[Violation]:
    if f"{os.sep}kernels{os.sep}" not in os.path.abspath(path):
        return []
    return [Violation(path, node.lineno, "kernel-assert",
                      "bare assert in kernels/ vanishes under python -O; "
                      "raise ValueError")
            for node in ast.walk(tree) if isinstance(node, ast.Assert)]


def _traced_body_violations(tree: ast.Module, path: str) -> List[Violation]:
    out: List[Violation] = []
    seen: Set[Tuple[int, str]] = set()

    def add(line: int, rule: str, msg: str) -> None:
        if (line, rule) not in seen:
            seen.add((line, rule))
            out.append(Violation(path, line, rule, msg))

    for region in _collect_traced(tree):
        where = _name(region)
        for node in ast.walk(region):
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                for sub in ast.walk(node.test):
                    if _is_tensor_expr(sub):
                        call = ".".join(_chain(sub.func))
                        add(node.lineno, "traced-truthiness",
                            f"Python truthiness on {call}() in traced "
                            f"{where}(); keep it a tensor (torch.where)")
            if not isinstance(node, ast.Call):
                continue
            c = _chain(node.func)
            method = (node.func.attr if isinstance(node.func, ast.Attribute)
                      else None)
            if (len(c) == 1 and c[0] in ("float", "int", "bool")
                    and len(node.args) == 1
                    and _is_tensor_expr(node.args[0])):
                add(node.lineno, "traced-cast",
                    f"{c[0]}() of a tensor in traced {where}()")
            if method == "item" and not node.args:
                add(node.lineno, "traced-cast",
                    f".item() reads the device in traced {where}()")
            if method in _HOST_SYNC_METHODS or (
                    c[-1] in ("asarray", "array", "copy")
                    and c[0] in ("np", "numpy")):
                add(node.lineno, "host-sync-in-trace",
                    f"{'.'.join(c)}() in traced {where}() waits for the "
                    "device")
            if c[0] == "time" and c[-1] in ("time", "perf_counter",
                                            "monotonic"):
                add(node.lineno, "time-in-trace",
                    f"{'.'.join(c)}() in traced {where}() is read once "
                    "and replayed")
    return out


def lint_source(src: str, path: str) -> List[Violation]:
    """Every rule's violations in one file's source, with per-line noqa
    suppression applied (suppressed violations come back flagged, so the
    gate can count them)."""
    tree = ast.parse(src, filename=path)
    _set_parents(tree)
    raw = (_prng_violations(tree, path)
           + _mutable_default_violations(tree, path)
           + _kernel_assert_violations(tree, path)
           + _traced_body_violations(tree, path))
    srclines = src.splitlines()
    out = []
    for v in raw:
        line = srclines[v.line - 1] if 0 < v.line <= len(srclines) else ""
        out.append(dataclasses.replace(v, suppressed=NOQA + v.rule in line))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def lint_file(path: str) -> List[Violation]:
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    violations = lint_source(src, path)
    if "THREAD_ENTRY_POINTS" in src:
        from repro_torch.analysis import locks
        violations += locks.check_source(src, path)
    return violations


def iter_py_files(paths: Sequence[str],
                  include_fixtures: bool = False) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)                      # an explicit file: always
            continue
        for root, dirs, files in os.walk(p):
            if not include_fixtures and "fixtures" in root.split(os.sep):
                dirs[:] = []
                continue
            for f in sorted(files):
                if f.endswith(".py"):
                    out.append(os.path.join(root, f))
    return sorted(set(out))


def load_baseline(path: str) -> Set[Tuple[str, str]]:
    """Baseline entries are ``<path-suffix>:<rule>`` lines ('#' comments
    allowed); a violation matches when its rule matches and its path ends
    with the entry's path suffix."""
    entries: Set[Tuple[str, str]] = set()
    if not os.path.exists(path):
        return entries
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fpath, _, rule = line.rpartition(":")
            entries.add((fpath.replace("\\", "/"), rule))
    return entries


def _baselined(v: Violation, baseline: Set[Tuple[str, str]]) -> bool:
    vpath = v.path.replace(os.sep, "/")
    return any(rule == v.rule and vpath.endswith(fpath)
               for fpath, rule in baseline)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the port's trip-safety + thread-lockset lint")
    ap.add_argument("paths", nargs="*", default=[PKG])
    ap.add_argument("--report-only", action="store_true",
                    help="print violations but exit 0")
    ap.add_argument("--baseline", default=None,
                    help="known-violation file (path:rule lines); "
                    f"default {DEFAULT_BASELINE}")
    ap.add_argument("--max-suppressions", type=int, default=None,
                    help="fail when more than N '# repro: noqa-*' "
                    "suppressions are in effect")
    ap.add_argument("--include-fixtures", action="store_true",
                    help="also lint the analysis fixtures (each one "
                    "deliberately violates a rule)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    baseline = load_baseline(args.baseline or DEFAULT_BASELINE)
    files = iter_py_files(args.paths or [PKG], args.include_fixtures)
    active: List[Violation] = []
    suppressed: List[Violation] = []
    baselined: List[Violation] = []
    for path in files:
        for v in lint_file(path):
            if v.suppressed:
                suppressed.append(v)
            elif _baselined(v, baseline):
                baselined.append(v)
            else:
                active.append(v)

    if args.as_json:
        print(json.dumps({
            "files": len(files),
            "violations": [dataclasses.asdict(v) for v in active],
            "suppressed": [dataclasses.asdict(v) for v in suppressed],
            "baselined": [dataclasses.asdict(v) for v in baselined],
        }, indent=1))
    else:
        for v in active + suppressed:
            print(v.render())
        print(f"{len(files)} files: {len(active)} violation(s), "
              f"{len(suppressed)} suppressed, {len(baselined)} baselined")

    failed = bool(active)
    if (args.max_suppressions is not None
            and len(suppressed) > args.max_suppressions):
        print(f"suppression budget exceeded: {len(suppressed)} > "
              f"{args.max_suppressions}")
        failed = True
    if args.report_only:
        return 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
