"""``setup_s``: process start to the first timed batch: the graph load,
``shard_graph``, plan, compile (with the tile build) and warm-up."""


def read(run):
    return run.setup_s
