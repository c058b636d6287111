from repro_torch.configs.base import (BFS_WORKLOADS, LM_SHAPES, ArchSpec,
                                      BFSWorkload, LayerSpec, LMShape,
                                      MoEConfig, TransformerConfig,
                                      bfs_workload, get_arch, get_shape)

__all__ = ["BFS_WORKLOADS", "LM_SHAPES", "ArchSpec", "BFSWorkload",
           "LayerSpec", "LMShape", "MoEConfig", "TransformerConfig",
           "bfs_workload", "get_arch", "get_shape"]
