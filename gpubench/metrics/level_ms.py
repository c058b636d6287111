"""``level_ms``: the window's batch time over all its levels, in ms; the
levels are each batch's ``BFSResult.run_stats.levels``.  Batches under the
profiler are left out where others remain."""


def read(run):
    batches = run.batches[run.first_untraced:] or run.batches
    levels = sum(b.levels for b in batches)
    if not levels:
        return None
    return sum(b.seconds for b in batches) / levels * 1e3
