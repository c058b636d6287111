from repro_torch.configs.base import (BFS_WORKLOADS, LM_SHAPES, RECSYS_SHAPES,
                                      ArchSpec, BFSWorkload, LayerSpec,
                                      LMShape, MoEConfig, RecsysConfig,
                                      RecsysShape, TransformerConfig,
                                      bfs_workload, get_arch, get_shape)

__all__ = ["BFS_WORKLOADS", "LM_SHAPES", "RECSYS_SHAPES", "ArchSpec",
           "BFSWorkload", "LayerSpec", "LMShape", "MoEConfig", "RecsysConfig",
           "RecsysShape", "TransformerConfig", "bfs_workload", "get_arch",
           "get_shape"]
