"""Thread-lockset race lint for the serving engine and any class that
declares its threading discipline (the port's copy of
``repro.analysis.locks``: the same rules on the same tables).

A module opts in by declaring two module-level LITERAL tables (read with
``ast.literal_eval``: the pass never imports the target code):

``THREAD_ENTRY_POINTS = {"group": ("method", ...), ...}``
    The methods each thread group enters the class through: the engine's
    ``caller`` (public API), ``admit`` / ``dispatch`` / ``stream``
    (pipeline threads), ``supervisor`` (watchdog callbacks).

``GUARDED_BY = {"_attr": "_lock_name" | "internal" | "atomic" |
               "ordered" | "init", ...}``
    The guard discipline per shared attribute. A lock name is VERIFIED:
    every write or mutation outside ``__init__`` must occur under
    ``with self.<lock>``. The special values document non-lock
    disciplines: ``internal`` (the object takes its own lock),
    ``atomic`` (single GIL-atomic reference or item assignment),
    ``ordered`` (accesses serialized by thread join / restart ordering),
    ``init`` (written only before the serving threads exist).

The pass builds, per thread group, the set of ``self.*`` attributes the
group's reachable methods read, write (plain / augmented assignment) or
mutate (``self.x[k] = v``, ``self.x.append(...)`` and friends), then fails
any attribute that (a) is written and touched by >= 2 groups, (b) has no
``GUARDED_BY`` entry, and (c) is not consistently accessed under one
``with self.<lock>``, plus any write that escapes its declared lock.

Attributes bound to ``threading.Lock/RLock/Condition/Event``,
``queue.Queue`` or ``itertools.count`` in ``__init__`` are auto-safe, as
are attributes never written outside ``__init__``.

:class:`repro_torch.analysis.recorder.ThreadAccessRecorder` is the run-time
twin.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.lint import Violation, _chain

GUARD_MODES = ("internal", "atomic", "ordered", "init")

_SAFE_CTORS = {"Lock", "RLock", "Condition", "Event", "Semaphore",
               "BoundedSemaphore", "Barrier", "Queue", "LifoQueue",
               "PriorityQueue", "SimpleQueue", "count"}
_MUTATORS = {"append", "appendleft", "extend", "extendleft", "pop",
             "popleft", "popitem", "remove", "clear", "add", "discard",
             "update", "insert", "setdefault", "sort", "reverse"}
_FUNC = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclasses.dataclass(frozen=True)
class Access:
    attr: str
    kind: str            # "read" | "write" | "mutate"
    locks: frozenset     # self.<lock> contexts held at the access
    method: str
    line: int


def _literal_table(tree: ast.Module, name: str) -> Optional[dict]:
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name):
            return ast.literal_eval(node.value)
    return None


class _MethodScan(ast.NodeVisitor):
    """Accesses + self-call edges of one method body, tracking the
    ``with self.<lock>:`` context stack."""

    def __init__(self, method: str, lock_attrs: Set[str]):
        self.method = method
        self.lock_attrs = lock_attrs
        self.accesses: List[Access] = []
        self.calls: Set[str] = set()
        self._held: List[str] = []

    def _self_attr(self, node: ast.AST) -> Optional[str]:
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    def _note(self, attr: str, kind: str, line: int) -> None:
        self.accesses.append(Access(attr, kind, frozenset(self._held),
                                    self.method, line))

    def visit_With(self, node: ast.With) -> None:
        held = []
        for item in node.items:
            attr = self._self_attr(item.context_expr)
            if attr is not None and attr in self.lock_attrs:
                held.append(attr)
        self._held.extend(held)
        self.generic_visit(node)
        for _ in held:
            self._held.pop()

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = self._self_attr(node)
        if attr is None:
            self.generic_visit(node)
            return
        parent = getattr(node, "_repro_parent", None)
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self._note(attr, "write", node.lineno)
        elif isinstance(parent, ast.Subscript) and isinstance(
                parent.ctx, (ast.Store, ast.Del)):
            self._note(attr, "mutate", node.lineno)
        elif (isinstance(parent, ast.Attribute)
              and parent.attr in _MUTATORS
              and isinstance(getattr(parent, "_repro_parent", None),
                             ast.Call)):
            self._note(attr, "mutate", node.lineno)
            self.calls.add(attr)          # may be a method ref; filtered later
        else:
            self._note(attr, "read", node.lineno)
            self.calls.add(attr)          # method refs double as call edges
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        # super().m(...) edges.
        f = node.func
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Call)
                and isinstance(f.value.func, ast.Name)
                and f.value.func.id == "super"):
            self.calls.add(f.attr)
        self.generic_visit(node)


def check_source(src: str, path: str) -> List[Violation]:
    tree = ast.parse(src, filename=path)
    entry_points = _literal_table(tree, "THREAD_ENTRY_POINTS")
    if not entry_points:
        return []
    guarded: Dict[str, str] = _literal_table(tree, "GUARDED_BY") or {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._repro_parent = node  # type: ignore[attr-defined]

    # Merge every class in the module: the async engine subclasses the
    # sync engine in the same file, and entry points name methods of both.
    methods: Dict[str, List[ast.AST]] = {}
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        for item in node.body:
            if isinstance(item, _FUNC):
                methods.setdefault(item.name, []).append(item)

    # Auto-safe attributes: lock/queue/counter constructors in __init__.
    lock_attrs: Set[str] = set()
    for init in methods.get("__init__", []):
        for node in ast.walk(init):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and _chain(node.value.func)[-1] in _SAFE_CTORS):
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        lock_attrs.add(t.attr)
    lock_names = {g for g in guarded.values() if g not in GUARD_MODES}
    lock_attrs |= lock_names

    scans: Dict[str, List[_MethodScan]] = {}
    for name, defs in methods.items():
        for d in defs:
            scan = _MethodScan(name, lock_names | lock_attrs)
            scan.visit(d)
            scans.setdefault(name, []).append(scan)

    def reachable(entries: Tuple[str, ...]) -> Set[str]:
        seen: Set[str] = set()
        stack = [m for m in entries if m in scans]
        while stack:
            m = stack.pop()
            if m in seen:
                continue
            seen.add(m)
            for scan in scans[m]:
                for callee in scan.calls:
                    if callee in scans and callee not in seen:
                        stack.append(callee)
        return seen

    # attr -> group -> accesses (data attrs only: method names excluded).
    by_attr: Dict[str, Dict[str, List[Access]]] = {}
    for group, entries in entry_points.items():
        for m in reachable(tuple(entries)):
            for scan in scans[m]:
                for acc in scan.accesses:
                    if acc.attr in methods or acc.attr in lock_attrs:
                        continue
                    by_attr.setdefault(acc.attr, {}).setdefault(
                        group, []).append(acc)

    out: List[Violation] = []
    for attr in sorted(by_attr):
        groups = by_attr[attr]
        writes = [a for g in groups.values() for a in g
                  if a.kind in ("write", "mutate")
                  and a.method != "__init__"]
        guard = guarded.get(attr)
        if guard is not None and guard not in GUARD_MODES:
            escaped = [a for a in writes if guard not in a.locks]
            for a in escaped:
                out.append(Violation(
                    path, a.line, "lockset",
                    f"self.{attr} written in {a.method}() outside its "
                    f"declared guard self.{guard}"))
            continue
        if guard in GUARD_MODES:
            continue
        if len(groups) < 2 or not writes:
            continue                       # single-threaded or init-only
        all_accesses = [a for g in groups.values() for a in g
                        if a.method != "__init__"]
        common = frozenset.intersection(
            *[a.locks for a in all_accesses]) if all_accesses else frozenset()
        if common:
            continue                       # consistently locked, undeclared
        a = writes[0]
        out.append(Violation(
            path, a.line, "lockset",
            f"self.{attr} is shared by thread groups "
            f"{sorted(groups)} with no GUARDED_BY entry and no "
            "consistent lock"))
    # One method reachable from several groups records its accesses once
    # per group — report each (line, message) once.
    seen: Set[Tuple[int, str]] = set()
    deduped = []
    for v in sorted(out, key=lambda v: (v.line, v.msg)):
        if (v.line, v.msg) not in seen:
            seen.add((v.line, v.msg))
            deduped.append(v)
    return deduped


def check_file(path: str) -> List[Violation]:
    with open(path, "r", encoding="utf-8") as f:
        return check_source(f.read(), path)


if __name__ == "__main__":
    import sys
    bad = [v for p in sys.argv[1:] for v in check_file(p)]
    for v in bad:
        print(v.render())
    sys.exit(1 if bad else 0)
