"""BFS workloads — the port's copy of ``repro.configs.base``'s BFS part
(the paper's own experiments, §4, plus the Graph500 Kronecker graph)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BFSWorkload:
    name: str
    graph: str                     # generators.GENERATORS key
    n_vertices: int
    gen_kwargs: tuple = ()         # sorted (k, v) pairs
    n_sources: int = 1


BFS_WORKLOADS = (
    BFSWorkload("star_4m", "star", 4_000_000),
    BFSWorkload("erdos_renyi_100k", "erdos_renyi", 100_000,
                (("avg_degree", 16.0),)),
    BFSWorkload("small_world_100k", "small_world", 100_000,
                (("beta", 0.1), ("k", 16))),
    BFSWorkload("rmat_1m", "rmat", 1_048_576, (("edge_factor", 16),)),
)


def bfs_workload(name: str) -> BFSWorkload:
    """Look a workload up by name."""
    for w in BFS_WORKLOADS:
        if w.name == name:
            return w
    raise KeyError(f"unknown BFS workload {name!r}; have "
                   f"{[w.name for w in BFS_WORKLOADS]}")
