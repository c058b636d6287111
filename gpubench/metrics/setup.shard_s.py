"""``setup.shard_s``: host seconds of ``graphs.formats.shard_graph`` on
the configuration's edge list (the benchmark's span around the call)."""


def read(run):
    return run.spans.get("shard_graph")
