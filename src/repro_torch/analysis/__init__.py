"""Measurement passes over the port's runs.

* ``analysis.trace_model`` — parse a ``torch.profiler`` chrome trace into
  per-phase and per-level BFS timings (the port of
  ``repro.analysis.trace_model``), read from the level loop's
  ``bfs.*`` profiler ranges (``core.spans``).

The JAX package's static auditors (``hlo_audit``, ``lint``, ``locks``,
``report``) are not ported yet.
"""
