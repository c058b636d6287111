"""The paper's primary contribution, ported to PyTorch: 1-D (and 2-D)
partitioned distributed BFS with optimized owner-exchange communication.

Public lifecycle: ``plan(graph, opts, mesh=..., device=...) -> BFSPlan ->
.compile() -> BFSEngine -> .run(sources) / .run_async(sources) ->
BFSResult``, in the dense, queue and ``auto`` modes, over a ``LocalMesh`` of
p shards on one device (an ``r x c`` ``LocalMesh.grid`` under
``partition="2d"``).
"""

from repro_torch.core.bfs import (BFSOptions, BFSStats, INF,
                                  validate_sources)
from repro_torch.core.engine import (BFSEngine, BFSPlan, BFSResult,
                                     BFSRunStats, plan, resolve_device)
from repro_torch.core.exchange import (DENSE_STRATEGIES,
                                       EXPAND_ROW_STRATEGIES,
                                       EXPAND_ROW_SPARSE_STRATEGIES,
                                       FOLD_COL_STRATEGIES,
                                       FOLD_COL_SPARSE_STRATEGIES,
                                       QUEUE_STRATEGIES, ExchangeStrategy,
                                       exchange_dense, get_exchange,
                                       register_exchange, select_exchange,
                                       unregister_exchange)
from repro_torch.core.mesh import LocalMesh, default_grid
from repro_torch.core.partition import Partition1D, Partition2D

__all__ = [
    "BFSOptions", "BFSStats", "INF", "validate_sources",
    "BFSEngine", "BFSPlan", "BFSResult", "BFSRunStats", "plan",
    "resolve_device", "LocalMesh", "default_grid", "Partition1D",
    "Partition2D",
    "exchange_dense", "ExchangeStrategy", "register_exchange",
    "unregister_exchange", "get_exchange", "select_exchange",
    "DENSE_STRATEGIES", "QUEUE_STRATEGIES", "EXPAND_ROW_STRATEGIES",
    "FOLD_COL_STRATEGIES", "EXPAND_ROW_SPARSE_STRATEGIES",
    "FOLD_COL_SPARSE_STRATEGIES",
]
