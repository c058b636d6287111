"""``collective_ms``: device ms a traced batch under the
``bfs.collective`` profiler range (every ``LocalMesh`` collective), by the
phase split of ``gpubench/tracing.py``."""


def read(run):
    if run.trace is None or not run.trace.ops or not run.traced:
        return None
    return run.trace.phase_s["collective"] / len(run.traced) * 1e3
