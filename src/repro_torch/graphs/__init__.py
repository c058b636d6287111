from repro_torch.graphs.formats import (DeviceBlockCache, ShardedGraph,
                                        ShardedGraph2D, device_block_cache,
                                        block_sparse_adjacency, csr_from_coo,
                                        from_jax_arrays, from_jax_arrays_2d,
                                        shard_graph, shard_graph_2d,
                                        shard_node_array, to_2d)
from repro_torch.graphs.generators import (GENERATORS, batched_molecules,
                                           chain_graph, dedupe_edges,
                                           erdos_renyi, generate, rmat,
                                           small_world, star_graph,
                                           to_undirected)
