"""Annotation-driven lock-discipline analysis for the serving layer — the
port of ``repro.analysis.locks``, its logic unchanged, over the port's
``serve/``.

The serve/ threading contract is documented per class with guard
annotations in the class body::

    class LaneGate:
        # guarded-by(_lock): _queue, _inflight_bytes, admitted

Each annotation maps a lock attribute (a ``threading.Lock`` / ``RLock``
/ ``Condition`` assigned in ``__init__``) to the instance attributes it
guards.  This pass then walks every method and flags:

* **LK001** — a read or write of a guarded attribute while the guarding
  lock is not statically held (not lexically inside ``with self.<lock>:``).
  ``__init__`` is exempt (construction is single-threaded by contract);
  helpers that run with the lock held by their caller carry a reasoned
  ``# audit: allow(LK001) -- ...`` suppression on (or above) their
  ``def`` line, which covers the whole function body.
* **LK002** — a cycle in the lock-acquisition graph.  Edges come from
  lexically nested ``with`` blocks *and* from ``self.method()`` calls
  made while a lock is held, where the callee acquires further locks
  (one level of indirection — enough for this codebase's helper
  pattern).  Re-acquiring a held non-reentrant lock is a self-edge and
  reports as a cycle too.
* **LK003** — an annotation naming a lock attribute that ``__init__``
  never assigns a Lock/RLock/Condition to.

Classes without annotations are skipped entirely: lock-free designs
(``BFSService``'s single-dispatcher contract) stay unflagged, and
adding the first annotation to a class is what opts it in.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.lint import Suppressions
from repro_torch.analysis.report import AuditReport

_GUARD_RE = re.compile(r"#\s*guarded-by\((\w+)\):\s*([\w,\s]+)")
_LOCK_CTORS = {"Lock", "RLock", "Condition"}


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attributes ``__init__`` assigns a Lock/RLock/Condition to."""
    locks: Set[str] = set()
    for node in cls.body:
        if not (isinstance(node, ast.FunctionDef)
                and node.name == "__init__"):
            continue
        for stmt in ast.walk(node):
            if not isinstance(stmt, ast.Assign):
                continue
            val = stmt.value
            if not isinstance(val, ast.Call):
                continue
            fn = val.func
            ctor = fn.attr if isinstance(fn, ast.Attribute) else \
                fn.id if isinstance(fn, ast.Name) else ""
            if ctor not in _LOCK_CTORS:
                continue
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    locks.add(tgt.attr)
    return locks


def _annotations(cls: ast.ClassDef, src_lines: List[str]) -> Dict[str, str]:
    """{guarded_attr: lock_attr} from guarded-by comments in the class."""
    guarded: Dict[str, str] = {}
    end = max((getattr(n, "end_lineno", n.lineno) for n in cls.body),
              default=cls.lineno)
    for i in range(cls.lineno, min(end, len(src_lines)) + 1):
        m = _GUARD_RE.search(src_lines[i - 1])
        if not m:
            continue
        lock = m.group(1)
        for attr in m.group(2).split(","):
            attr = attr.strip()
            if attr:
                guarded[attr] = lock
    return guarded


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _MethodWalker(ast.NodeVisitor):
    """Tracks the statically-held lock set through one method body."""

    def __init__(self, owner: "_ClassAnalysis", fn: ast.FunctionDef):
        self.owner = owner
        self.fn = fn
        self.held: Tuple[str, ...] = ()
        self.def_lines = (fn.lineno, fn.lineno - 1)
        self.accesses: List[Tuple[str, int]] = []   # (attr, line) unguarded
        self.acquires: Set[str] = set()
        self.calls_under: List[Tuple[str, str, int]] = []  # (lock, meth, ln)

    def visit_With(self, node: ast.With) -> None:
        entered = []
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr in self.owner.locks:
                self.owner.add_edges(self.held, attr, node.lineno)
                entered.append(attr)
                self.acquires.add(attr)
        self.held = self.held + tuple(entered)
        for stmt in node.body:
            self.visit(stmt)
        if entered:
            self.held = self.held[:-len(entered)]
        for item in node.items:          # guards on the with-expr itself
            self.visit(item.context_expr)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr in self.owner.guarded:
            lock = self.owner.guarded[attr]
            if lock not in self.held:
                self.accesses.append((attr, node.lineno))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        meth = _self_attr(node.func)
        if meth and self.held:
            for lock in self.held:
                self.calls_under.append((lock, meth, node.lineno))
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested closures inherit the lexically-held lock set (they run
        # where they are defined in this codebase's helper pattern)
        for stmt in node.body:
            self.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef


class _ClassAnalysis:
    def __init__(self, cls: ast.ClassDef, src_lines: List[str]):
        self.cls = cls
        self.locks = _lock_attrs(cls)
        self.guarded = _annotations(cls, src_lines)
        self.edges: Set[Tuple[str, str, int]] = set()   # (from, to, line)
        self.method_acquires: Dict[str, Set[str]] = {}

    def add_edges(self, held: Tuple[str, ...], acquired: str,
                  line: int) -> None:
        for h in held:
            self.edges.add((h, acquired, line))
        if acquired in held:             # re-acquire: self-edge = cycle
            self.edges.add((acquired, acquired, line))


def _find_cycle(edges: Set[Tuple[str, str]]) -> Optional[List[str]]:
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    state: Dict[str, int] = {}
    path: List[str] = []

    def dfs(node: str) -> Optional[List[str]]:
        state[node] = 1
        path.append(node)
        for nxt in sorted(graph.get(node, ())):
            if state.get(nxt) == 1:
                return path[path.index(nxt):] + [nxt]
            if state.get(nxt, 0) == 0:
                cyc = dfs(nxt)
                if cyc:
                    return cyc
        state[node] = 2
        path.pop()
        return None

    for node in sorted(graph):
        if state.get(node, 0) == 0:
            cyc = dfs(node)
            if cyc:
                return cyc
    return None


def analyze_lock_source(src: str, path: str,
                        report: Optional[AuditReport] = None) -> AuditReport:
    """Run the lock pass over one module's source."""
    report = report if report is not None else AuditReport(f"locks:{path}")
    sup = Suppressions(src, path, report)
    try:
        module = ast.parse(src)
    except SyntaxError as e:
        report.add("LK003", f"unparseable module: {e}", file=path,
                   line=e.lineno or 0)
        return report
    src_lines = src.splitlines()
    all_edges: List[dict] = []
    for cls in [n for n in ast.walk(module) if isinstance(n, ast.ClassDef)]:
        ana = _ClassAnalysis(cls, src_lines)
        if not ana.guarded:
            continue
        for attr, lock in sorted(ana.guarded.items()):
            if lock not in ana.locks:
                line = cls.lineno
                reason = sup.reason("LK003", line, line - 1)
                report.add("LK003",
                           f"{cls.name}: guarded-by({lock}) names no "
                           "Lock/RLock/Condition assigned in __init__",
                           file=path, line=line,
                           suppressed=reason is not None,
                           suppress_reason=reason or "")
        methods = [n for n in cls.body if isinstance(n, ast.FunctionDef)]
        walkers = []
        for fn in methods:
            walker = _MethodWalker(ana, fn)
            for stmt in fn.body:
                walker.visit(stmt)
            ana.method_acquires[fn.name] = walker.acquires
            walkers.append(walker)
        for fn, walker in zip(methods, walkers):
            # held-lock -> callee-acquired-lock edges (one hop)
            for lock, meth, line in walker.calls_under:
                for acq in ana.method_acquires.get(meth, ()):
                    ana.add_edges((lock,), acq, line)
            if fn.name == "__init__":
                continue
            for attr, line in walker.accesses:
                lock = ana.guarded[attr]
                reason = sup.reason("LK001", line, line - 1,
                                    *walker.def_lines)
                report.add("LK001",
                           f"{cls.name}.{fn.name}: `self.{attr}` "
                           f"accessed without holding `self.{lock}`",
                           file=path, line=line,
                           suppressed=reason is not None,
                           suppress_reason=reason or "")
        cyc = _find_cycle({(f"{cls.name}.{a}", f"{cls.name}.{b}")
                           for a, b, _ in ana.edges})
        if cyc:
            line = min((ln for _, _, ln in ana.edges), default=cls.lineno)
            reason = sup.reason("LK002", line, line - 1)
            report.add("LK002",
                       f"{cls.name}: lock acquisition cycle "
                       f"{' -> '.join(cyc)}",
                       file=path, line=line,
                       suppressed=reason is not None,
                       suppress_reason=reason or "")
        all_edges.extend({"from": f"{cls.name}.{a}", "to": f"{cls.name}.{b}",
                          "file": path, "line": ln}
                         for a, b, ln in sorted(ana.edges))
    report.info.setdefault("lock_edges", []).extend(all_edges)
    return report


SERVE_MODULES = ("engine_cache.py", "bfs_service.py",
                 os.path.join("frontend", "server.py"),
                 os.path.join("frontend", "admission.py"),
                 os.path.join("frontend", "metrics.py"),
                 os.path.join("resilience", "faults.py"),
                 os.path.join("resilience", "breaker.py"),
                 os.path.join("resilience", "watchdog.py"))


def analyze_serve(root: Optional[str] = None) -> AuditReport:
    """Run the lock pass over the serving layer (gate / CLI entry point)."""
    if root is None:
        from repro_torch.analysis.lint import repo_root
        root = os.path.join(repo_root(), "serve")
    report = AuditReport("locks:serve")
    for rel in SERVE_MODULES:
        path = os.path.join(root, rel)
        with open(path, encoding="utf-8") as f:
            analyze_lock_source(f.read(), os.path.relpath(
                path, os.path.dirname(os.path.dirname(root))), report)
    return report
