"""The paper's primary contribution, ported to PyTorch: 1-D (and 2-D)
partitioned distributed BFS with optimized owner-exchange communication.

Public lifecycle: ``plan(graph, opts, mesh=..., device=...) -> BFSPlan ->
.compile() -> BFSEngine -> .run(sources) / .run_async(sources) ->
BFSResult``, in the dense, queue and ``auto`` modes, over a ``LocalMesh`` of
p shards on one device (an ``r x c`` ``LocalMesh.grid`` under
``partition="2d"``), or over a ``DistMesh``, one shard per rank of a
``torch.distributed`` group.  The one-shot ``bfs()`` remains as a deprecated
wrapper over that lifecycle, as in the JAX package, in
``repro_torch.core.bfs``; unlike there it is not re-exported here, where
its name would shadow that module.
"""

from repro_torch.core.bfs import (BFSOptions, BFSStats, INF,
                                  validate_sources)
from repro_torch.core.dist_mesh import DistMesh
from repro_torch.core.engine import (BFSEngine, BFSPlan, BFSResult,
                                     BFSRunStats, normalize_ladder,
                                     pick_bucket, plan, plan_ladder,
                                     resolve_device)
from repro_torch.core.exchange import (DENSE_STRATEGIES,
                                       EXPAND_ROW_STRATEGIES,
                                       EXPAND_ROW_SPARSE_STRATEGIES,
                                       FOLD_COL_STRATEGIES,
                                       FOLD_COL_SPARSE_STRATEGIES,
                                       QUEUE_STRATEGIES, ExchangeStrategy,
                                       exchange_dense, exchange_queue,
                                       expand_row, fold_col, get_exchange,
                                       register_exchange, select_exchange,
                                       unregister_exchange)
from repro_torch.core.mesh import LocalMesh, default_grid
from repro_torch.core.partition import (Partition, Partition1D, Partition2D,
                                        repartition)

__all__ = [
    "BFSOptions", "BFSStats", "INF", "validate_sources",
    "BFSEngine", "BFSPlan", "BFSResult", "BFSRunStats", "plan",
    "plan_ladder", "normalize_ladder", "pick_bucket", "resolve_device",
    "LocalMesh", "DistMesh", "default_grid", "Partition", "Partition1D",
    "Partition2D", "repartition",
    "exchange_dense", "exchange_queue", "expand_row", "fold_col",
    "ExchangeStrategy", "register_exchange",
    "unregister_exchange", "get_exchange", "select_exchange",
    "DENSE_STRATEGIES", "QUEUE_STRATEGIES", "EXPAND_ROW_STRATEGIES",
    "FOLD_COL_STRATEGIES", "EXPAND_ROW_SPARSE_STRATEGIES",
    "FOLD_COL_SPARSE_STRATEGIES",
]
