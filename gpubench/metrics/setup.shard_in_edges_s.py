"""``setup.shard_in_edges_s``: host seconds ``shard_graph`` spends
bucketing the in-edges, the program's ``graph.shard.in_edges`` span
(``repro_torch.core.spans``; inside ``setup.shard_s``).  Only the
bottom-up levels of ``mode="auto"`` read the in-edges."""

from gpubench import recorder


def read(run):
    return recorder.setup_seconds(run, "graph.shard.in_edges")
