"""Measurement and audit passes over the port's runs and sources.

One report format (``analysis.report.AuditReport``, the JAX rule ids)
for the three auditors:

* ``analysis.collective_audit`` — drive one traversal of an engine's
  plan on a recording ``LocalMesh`` and assert its collective census
  against the plan's resolved strategies and byte models, with the
  host-read budget, buffer reuse and retrace checks (the port of
  ``repro.analysis.hlo_audit``).  Rules HA001-HA007.
* ``analysis.lint`` — AST lints over ``src/repro_torch``: exchange-
  registry signature/purity/twin discipline and level-loop hygiene
  (every device read listed).  Rules RX001-RX005.
* ``analysis.locks`` — guarded-by annotation checking and lock-order
  cycle detection over ``serve/``.  Rules LK001-LK003.

and ``analysis.trace_model``, which parses a ``torch.profiler`` chrome
trace into per-phase and per-level BFS timings from the level loop's
``bfs.*`` profiler ranges (``core.spans``).

CLI: ``python -m repro_torch.launch.bfs_audit`` (the gate); inline:
``bfs_run --audit``.  Suppressions: ``# audit: allow(<rule>) -- reason``.
"""

from repro_torch.analysis import (collective_audit, lint, locks,  # noqa: F401
                                  report, trace_model)
from repro_torch.analysis.report import RULES, AuditReport, Violation

__all__ = ["AuditReport", "Violation", "RULES", "collective_audit", "lint",
           "locks", "report", "trace_model"]
