"""``expand_ms``: device ms a traced batch under the ``bfs.expand``
profiler range (``core/spans.py``), by the phase split of
``gpubench/tracing.py``."""


def read(run):
    if run.trace is None or not run.trace.ops or not run.traced:
        return None
    return run.trace.phase_s["expand"] / len(run.traced) * 1e3
