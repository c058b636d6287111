from repro_torch.configs.base import BFS_WORKLOADS, BFSWorkload, bfs_workload

__all__ = ["BFS_WORKLOADS", "BFSWorkload", "bfs_workload"]
