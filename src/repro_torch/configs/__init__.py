from repro_torch.configs.base import (ARCH_IDS, BFS_WORKLOADS, GNN_SHAPES,
                                      LM_SHAPES, RECSYS_SHAPES, ArchSpec,
                                      BFSWorkload, GNNConfig, GNNShape,
                                      LayerSpec, LMShape, MoEConfig,
                                      RecsysConfig, RecsysShape,
                                      TransformerConfig, all_cells,
                                      bfs_workload, get_arch, get_shape,
                                      registry)

__all__ = ["ARCH_IDS", "BFS_WORKLOADS", "GNN_SHAPES", "LM_SHAPES",
           "RECSYS_SHAPES", "ArchSpec", "BFSWorkload", "GNNConfig",
           "GNNShape", "LayerSpec", "LMShape", "MoEConfig", "RecsysConfig",
           "RecsysShape", "TransformerConfig", "all_cells", "bfs_workload",
           "get_arch", "get_shape", "registry"]
