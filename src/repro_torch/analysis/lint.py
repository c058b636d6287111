"""AST lints for the port's conventions (rules RX001-RX005) — the port of
``repro.analysis.lint``.

Three families of invariants the exchange registry and the level loop
depend on, enforced statically over ``src/repro_torch``:

* **Registry discipline** — every ``register_exchange(kind, name,
  bytes_model, wire=...)`` call (a decorator, a call, or one row of a
  ``for`` over a literal table of registrations) pairs a byte model
  with the signature its kind demands (RX001), and the model is pure
  host Python: plan-time pricing must never touch ``torch`` (RX002).
  Byte-model signatures per kind::

      dense / expand_row / fold_col          (n|_, ..., itemsize, ...)  5 args
      queue                                  (p, cap, itemsize, density=)  4
      expand_row_sparse / fold_col_sparse    (r, c, cap, itemsize, density=)  5

* **Twin coverage** — every bytes-tier strategy has its cheaper wire
  twin registered: ``<name>_packed`` for dense kinds,
  ``<name>_compressed`` for sparse kinds (RX003), so
  ``wire_format="auto"`` always has both tiers to price.

* **Level-loop hygiene** — in the modules the level loop runs
  (``core/bfs.py``, ``core/frontier.py``), every read of the device is
  visible (RX004): a Python ``if``, ``while`` or ``bool()`` over a
  tensor expression (one naming ``torch`` or calling a tensor reduction
  such as ``.any()``) is a hidden host sync, and an explicit read
  (``.tolist()``, ``.item()``, ``.cpu()``, ``.numpy()``,
  ``mesh.host_read``) is flagged too, so each budgeted read carries a
  reasoned suppression and the suppressions list the loop's read sites
  (``host_read_sites``, which the collective audit's HA005 checks the
  recorded reads against).  No host clock calls either (RX005): a
  level's host time is its ``bfs.level`` span (``core.spans``).

False positives are silenced inline with a reasoned suppression::

    # audit: allow(RX004) -- budget: a dense level's one read

The reason string after ``--`` is mandatory: a bare ``allow`` is itself
a violation (SUP001).  A suppression comment matches on its own line,
the line above the flagged statement, or the flagged statement's line.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.report import AuditReport

# byte-model signature per kind: (positional arity, trailing kwarg that
# must carry a default — the density knob of the sparse tiers)
MODEL_SPEC: Dict[str, Tuple[int, Optional[str]]] = {
    "dense": (5, None),
    "expand_row": (5, None),
    "fold_col": (5, None),
    "queue": (4, "density"),
    "expand_row_sparse": (5, "density"),
    "fold_col_sparse": (5, "density"),
}
DENSE_KINDS = ("dense", "expand_row", "fold_col")
SPARSE_KINDS = ("queue", "expand_row_sparse", "fold_col_sparse")
TRACED_MODULES = ("core/bfs.py", "core/frontier.py")
_CLOCK_CALLS = {("time", "time"), ("time", "perf_counter"),
                ("time", "monotonic"), ("time", "process_time")}
# calls that copy a tensor to the host, and tensor methods whose result
# a Python branch would have to read
_HOST_READS = {"tolist", "item", "cpu", "numpy", "host_read"}
_TENSOR_METHODS = {"any", "all", "sum", "max", "min", "nonzero", "equal",
                   "count_nonzero"} | _HOST_READS

_ALLOW_RE = re.compile(
    r"#\s*audit:\s*allow\(([A-Z]{2,3}[0-9]{3})\)(?:\s*--\s*(.*\S))?")


class Suppressions:
    """Inline ``# audit: allow(RULE) -- reason`` comments of one file."""

    def __init__(self, src: str, path: str,
                 report: Optional[AuditReport] = None):
        self.by_line: Dict[int, Tuple[str, str]] = {}
        for i, line in enumerate(src.splitlines(), 1):
            m = _ALLOW_RE.search(line)
            if not m:
                continue
            rule, reason = m.group(1), m.group(2)
            if not reason:
                if report is not None:
                    report.add("SUP001",
                               f"allow({rule}) without a `-- reason`",
                               file=path, line=i)
                continue
            self.by_line[i] = (rule, reason)

    def reason(self, rule: str, *lines: int) -> Optional[str]:
        """Suppression reason if any candidate line allows ``rule``."""
        for ln in lines:
            ent = self.by_line.get(ln)
            if ent and ent[0] == rule:
                return ent[1]
        return None


def _flag(report: AuditReport, sup: Suppressions, rule: str, message: str,
          path: str, line: int, extra_lines: Tuple[int, ...] = ()) -> None:
    reason = sup.reason(rule, line, line - 1, *extra_lines)
    report.add(rule, message, file=path, line=line,
               suppressed=reason is not None,
               suppress_reason=reason or "")


def _references(tree: ast.AST, names: Tuple[str, ...]) -> Optional[ast.AST]:
    """First node under ``tree`` naming one of ``names`` (torch, ...)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id in names:
            return node
    return None


def _tensor_expr(tree: ast.AST) -> Optional[ast.AST]:
    """First node under ``tree`` that makes it a tensor expression: a
    name ``torch`` or a call of a tensor reduction or host read."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id == "torch":
            return node
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _TENSOR_METHODS):
            return node
    return None


def _model_def(module: ast.Module, expr: ast.AST):
    """Resolve a register_exchange byte-model argument to its function.

    Returns the FunctionDef/Lambda, or None when the expression is
    dynamic (attribute chains, calls) and can't be checked statically.
    """
    if isinstance(expr, ast.Lambda):
        return expr
    if not isinstance(expr, ast.Name):
        return None
    for node in module.body:
        if isinstance(node, ast.FunctionDef) and node.name == expr.id:
            return node
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == expr.id \
                        and isinstance(node.value, ast.Lambda):
                    return node.value
    return None


def _check_model(report: AuditReport, sup: Suppressions, path: str,
                 line: int, kind: str, name: str, model) -> None:
    spec = MODEL_SPEC.get(kind)
    if spec is None or model is None:
        return
    arity, tail = spec
    args = model.args
    n_pos = len(args.args) + len(args.posonlyargs)
    lines = (line,)
    if n_pos != arity:
        _flag(report, sup, "RX001",
              f"byte model for ({kind!r}, {name!r}) takes {n_pos} "
              f"positional args, kind expects {arity}",
              path, line, lines)
        return
    if tail is not None:
        last = (args.posonlyargs + args.args)[-1]
        if last.arg != tail or not args.defaults:
            _flag(report, sup, "RX001",
                  f"byte model for ({kind!r}, {name!r}) must end with "
                  f"a defaulted `{tail}=` parameter",
                  path, line, lines)
    body = model.body if isinstance(model, ast.Lambda) else model
    traced = _references(body, ("torch",))
    if traced is not None:
        _flag(report, sup, "RX002",
              f"byte model for ({kind!r}, {name!r}) references "
              "torch — plan-time pricing must be pure Python",
              path, getattr(traced, "lineno", line),
              (line, getattr(model, "lineno", line)))


def _call_parts(node: ast.Call):
    """``(kind, name, model_expr, wire)`` expressions of one
    register_exchange call, or None when it is not one."""
    fn = node.func
    fn_name = fn.id if isinstance(fn, ast.Name) else \
        fn.attr if isinstance(fn, ast.Attribute) else ""
    if fn_name != "register_exchange" or len(node.args) < 2:
        return None
    model_expr = node.args[2] if len(node.args) > 2 else None
    wire = None
    for kw in node.keywords:
        if kw.arg == "bytes_model":
            model_expr = kw.value
        if kw.arg == "wire":
            wire = kw.value
    return node.args[0], node.args[1], model_expr, wire


def _const(expr, env: dict):
    """The value of a constant, or of a name bound in ``env``."""
    if isinstance(expr, ast.Name) and expr.id in env:
        expr = env[expr.id]
    return expr.value if isinstance(expr, ast.Constant) else None


def _loop_rows(node: ast.For):
    """``{name: expr}`` of each row of ``for a, b, ... in ((...), ...)``
    over a literal table, or nothing."""
    tgt = node.target
    if not (isinstance(tgt, ast.Tuple)
            and all(isinstance(e, ast.Name) for e in tgt.elts)
            and isinstance(node.iter, (ast.Tuple, ast.List))):
        return
    names = [e.id for e in tgt.elts]
    for row in node.iter.elts:
        if isinstance(row, ast.Tuple) and len(row.elts) == len(names):
            yield row, dict(zip(names, row.elts))


def _registrations(module: ast.Module):
    """Every register_exchange call: (line, kind, name, model_expr, wire);
    a call in the body of a ``for`` over a literal table counts once a
    row, at the row's line."""
    for node in ast.walk(module):
        calls = ([(node, {}, node.lineno)] if isinstance(node, ast.Call)
                 else [])
        if isinstance(node, ast.For):
            calls = [(call, env, row.lineno)
                     for row, env in _loop_rows(node)
                     for stmt in node.body for call in ast.walk(stmt)
                     if isinstance(call, ast.Call)]
        for call, env, line in calls:
            parts = _call_parts(call)
            if parts is None:
                continue
            kind_e, name_e, model_expr, wire_e = parts
            kind, name = _const(kind_e, env), _const(name_e, env)
            if kind is None or name is None:
                continue
            if isinstance(model_expr, ast.Name) and model_expr.id in env:
                model_expr = env[model_expr.id]
            wire = "bytes" if wire_e is None else _const(wire_e, env)
            yield line, kind, name, model_expr, wire or "bytes"


def _lint_traced_module(report: AuditReport, sup: Suppressions,
                        path: str, module: ast.Module) -> None:
    flagged = set()

    def rx004(line: int, message: str) -> None:
        if line not in flagged:
            flagged.add(line)
            _flag(report, sup, "RX004", message, path, line)

    for node in ast.walk(module):
        if isinstance(node, (ast.If, ast.While)):
            hit = _tensor_expr(node.test)
            if hit is not None:
                rx004(node.lineno,
                      f"Python `{type(node).__name__.lower()}` over a tensor"
                      " expression — a hidden host read in level-loop code")
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id == "bool" and node.args \
                and _tensor_expr(node.args[0]) is not None:
            rx004(node.lineno, "`bool()` over a tensor expression — a "
                               "hidden host read in level-loop code")
        if isinstance(fn, ast.Attribute) and fn.attr in _HOST_READS:
            rx004(node.lineno, f".{fn.attr}() reads the device from "
                               "level-loop code")
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
                and (fn.value.id, fn.attr) in _CLOCK_CALLS:
            _flag(report, sup, "RX005",
                  f"{fn.value.id}.{fn.attr}() inside a level-loop module "
                  "— a host clock times the enqueue, not the device",
                  path, node.lineno)


def lint_sources(sources: Dict[str, str],
                 name: str = "lint") -> AuditReport:
    """Lint a {path: source} mapping (the unit-testable entry point)."""
    report = AuditReport(name)
    regs: List[Tuple[str, str, str, str, int]] = []
    for path, src in sorted(sources.items()):
        sup = Suppressions(src, path, report)
        try:
            module = ast.parse(src)
        except SyntaxError as e:
            report.add("RX001", f"unparseable module: {e}", file=path,
                       line=e.lineno or 0)
            continue
        for line, kind, sname, model_expr, wire in _registrations(module):
            if model_expr is None:
                _flag(report, sup, "RX001",
                      f"register_exchange({kind!r}, {sname!r}) has no "
                      "byte model", path, line)
                continue
            model = _model_def(module, model_expr)
            _check_model(report, sup, path, line, kind, sname, model)
            regs.append((kind, sname, wire, path, line))
        norm = path.replace(os.sep, "/")
        if any(norm.endswith(m) for m in TRACED_MODULES):
            _lint_traced_module(report, sup, path, module)

    registered = {(k, n) for k, n, _, _, _ in regs}
    sup_by_path = {path: Suppressions(src, path)
                   for path, src in sources.items()}
    for kind, sname, wire, path, line in regs:
        if wire != "bytes":
            continue
        twin = sname + ("_packed" if kind in DENSE_KINDS else "_compressed")
        if (kind, twin) not in registered:
            _flag(report, sup_by_path[path], "RX003",
                  f"bytes-tier strategy ({kind!r}, {sname!r}) has no "
                  f"({kind!r}, {twin!r}) twin — wire_format='auto' "
                  "cannot price the cheaper tier", path, line)
    report.info["registrations"] = [
        {"kind": k, "name": n, "wire": w, "file": p, "line": ln}
        for k, n, w, p, ln in regs]
    return report


def repo_root() -> str:
    """The port package's directory (``src/repro_torch``)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read_tree(root: str, only=None) -> Dict[str, str]:
    sources: Dict[str, str] = {}
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, os.path.dirname(root))
            if only and not any(rel.replace(os.sep, "/").endswith(m)
                                for m in only):
                continue
            with open(path, encoding="utf-8") as f:
                sources[rel.replace(os.sep, "/")] = f.read()
    return sources


def lint_tree(root: Optional[str] = None) -> AuditReport:
    """Lint every module under ``src/repro_torch`` (gate / CLI entry)."""
    return lint_sources(_read_tree(root or repo_root()),
                        name="lint:src/repro_torch")


def host_read_sites(root: Optional[str] = None) -> set:
    """``{(file, line)}`` of the level loop's listed device reads: the
    RX004 rows of the level-loop modules suppressed with a reason
    (``file`` as ``repro_torch/core/bfs.py``)."""
    rep = lint_sources(_read_tree(root or repo_root(), TRACED_MODULES))
    return {(v.file, v.line) for v in rep.violations
            if v.rule == "RX004" and v.suppressed}
