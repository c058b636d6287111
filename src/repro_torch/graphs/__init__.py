from repro_torch.graphs.formats import (ShardedGraph, block_sparse_adjacency,
                                        csr_from_coo, from_jax_arrays,
                                        shard_graph)
from repro_torch.graphs.generators import (GENERATORS, batched_molecules,
                                           chain_graph, dedupe_edges,
                                           erdos_renyi, generate, rmat,
                                           small_world, star_graph,
                                           to_undirected)
