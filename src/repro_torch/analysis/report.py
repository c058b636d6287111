"""Machine-readable audit results shared by the analysis passes — the port
of ``repro.analysis.report``.

Every pass (``collective_audit``, ``lint``, ``locks``) emits an
``AuditReport``: a named list of ``Violation`` rows plus a free-form
``info`` payload (census tables, lock graphs, ...).  Rule ids are the
JAX package's, stable strings the tests and the gate match on:

  HA001-HA007  plan auditor over the collectives a traversal makes
               (analysis/collective_audit.py)
  RX001-RX005  exchange-registry / level-loop lint (analysis/lint.py)
  LK001-LK003  serve/ lock discipline (analysis/locks.py)
  SUP001       malformed ``# audit: allow(...)`` suppression

A violation carrying ``suppressed=True`` was matched by an inline
``# audit: allow(<rule>) -- <reason>`` comment; it stays in the report
(the suppression inventory is part of the audit) but does not fail it.
A violation of severity ``info`` (a role whose level kind the audited
traversal never reached) is reported and does not fail it either.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List

RULES = {
    # --- plan auditor over the recorded collectives
    "HA001": "required collective missing from every level of its kind",
    "HA002": "collective in a level not priced by any plan byte model",
    "HA003": "recorded collective bytes drift outside the model tolerance",
    "HA004": "dist buffer reused no longer (the engine reallocated it)",
    "HA005": "host reads in a level past the budget, or at an unlisted site",
    "HA006": "engine retraced after compile (trace pinning broken)",
    "HA007": "collective group size disagrees with the plan axis",
    # --- registry / level-loop lint
    "RX001": "register_exchange byte model has the wrong signature",
    "RX002": "register_exchange byte model is not pure Python (torch)",
    "RX003": "bytes-tier strategy lacks its packed/compressed twin",
    "RX004": "Python `if`/`while`/`bool()` over a tensor, or a host read, "
             "in a level-loop module",
    "RX005": "host clock call inside a level-loop module",
    # --- lock discipline
    "LK001": "guarded attribute accessed outside `with <lock>:`",
    "LK002": "lock-acquisition ordering cycle",
    "LK003": "guarded-by annotation names an unknown lock",
    # --- suppression syntax
    "SUP001": "audit suppression without a `-- reason` string",
}


@dataclasses.dataclass
class Violation:
    rule: str
    message: str
    severity: str = "error"       # error | warning | info
    file: str = ""
    line: int = 0
    suppressed: bool = False
    suppress_reason: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        loc = f"{self.file}:{self.line}: " if self.file else ""
        sup = f" [suppressed: {self.suppress_reason}]" if self.suppressed \
            else ""
        sev = "" if self.severity == "error" else f" ({self.severity})"
        return f"{loc}{self.rule}{sev}: {self.message}{sup}"


@dataclasses.dataclass
class AuditReport:
    name: str
    violations: List[Violation] = dataclasses.field(default_factory=list)
    info: dict = dataclasses.field(default_factory=dict)

    def add(self, rule: str, message: str, **kw) -> Violation:
        v = Violation(rule, message, **kw)
        self.violations.append(v)
        return v

    @property
    def failures(self) -> List[Violation]:
        return [v for v in self.violations
                if v.severity == "error" and not v.suppressed]

    def ok(self) -> bool:
        return not self.failures

    def rules(self) -> set:
        """Unsuppressed rule ids that fail the report — what the
        known-bad tests match (an ``info`` row reports, never fails)."""
        return {v.rule for v in self.violations
                if not v.suppressed and v.severity != "info"}

    def extend(self, other: "AuditReport") -> None:
        self.violations.extend(other.violations)

    def to_dict(self) -> dict:
        return {"name": self.name, "ok": self.ok(),
                "violations": [v.to_dict() for v in self.violations],
                "info": self.info}

    def to_json(self, indent=None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True,
                          default=str)

    def summary(self) -> str:
        n_sup = sum(1 for v in self.violations if v.suppressed)
        n_info = sum(1 for v in self.violations
                     if v.severity == "info" and not v.suppressed)
        status = "ok" if self.ok() else \
            f"FAIL ({len(self.failures)} violation(s))"
        extra = f", {n_sup} suppressed" if n_sup else ""
        extra += f", {n_info} info" if n_info else ""
        return f"[{self.name}] {status}{extra}"
