"""Level-synchronous BFS with 1-D partitioning (paper fig. 2) — the port of
``repro.core.bfs``, dense mode.

Every iteration of the level loop is one BFS level: local top-down
expansion (computation step, paper §2.3), the owner exchange
(communication step) and the owner-side distance update.  The p shards of
a ``LocalMesh`` run as one stacked ``(p, ...)`` computation.  JAX's
``lax.while_loop`` becomes a Python loop over levels; termination reads
``new.any()`` once per level, which is the one host sync of a level.

This module holds the options, source validation and the level loop; the
public lifecycle (``plan -> compile -> run``) lives in ``core/engine.py``.
The queue and direction-optimizing ``auto`` modes wait for ROADMAP Queue A
item 6.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import exchange as ex
from repro_torch.core import frontier as fr
from repro_torch.core.mesh import LocalMesh
from repro_torch.core.partition import Partition1D
# the module, not the function: kernels.fold_update imports core.frontier,
# so importing it first runs core/__init__, which lands here half-way
from repro_torch.kernels import fold_update as a1

INF = fr.INF


@dataclasses.dataclass(frozen=True)
class BFSOptions:
    mode: str = "dense"                       # dense | queue | auto
    dense_exchange: str = "alltoall_direct"   # see exchange.DENSE_STRATEGIES
    queue_exchange: str = "alltoall_direct"   # see exchange.QUEUE_STRATEGIES
    # 2-D (partition="2d") phase strategies; "auto" picks the registered
    # strategy with the smallest modeled bytes (exchange.select_exchange).
    expand_exchange: str = "allgather"        # see exchange.EXPAND_ROW_STRATEGIES
    fold_exchange: str = "alltoall_reduce"    # see exchange.FOLD_COL_STRATEGIES
    # sparse (queue/auto) 2-D phase strategies: id buffers on the wire
    expand_sparse_exchange: str = "allgather"       # EXPAND_ROW_SPARSE_...
    fold_sparse_exchange: str = "alltoall_direct"   # FOLD_COL_SPARSE_...
    local_update: bool = True                 # paper §5.1 opt (1)
    dedupe: bool = True                       # drop dup targets pre-wire
    queue_cap: int = 1024                     # ids per destination bucket
    max_levels: int = 0                       # 0 -> derive from n
    # auto-mode thresholds (fractions of global E / V):
    queue_threshold: float = 1 / 64           # frontier edges below -> queue
    bottom_up_threshold: float = 0.05         # frontier verts above -> bottom-up
    use_kernel: bool = False                  # bit-tile expansion
                                              # (bsr_expand_bits; dense
                                              # mode, 1-D partition)
    # Wire layout of the exchanges: "packed" ships 32-bit bitset words
    # (8x smaller, OR merges), "bytes" the uint8 mask, "compressed" the
    # delta+varint id streams of the sparse phases; "auto" prices every
    # layout per phase at plan time and picks the cheapest.
    wire_format: str = "auto"       # packed | bytes | compressed | auto
    # Visited sieve of the sparse phases; resolved at plan time.
    sieve: object = "auto"          # True | False | "auto"
    # Fused fold/owner-update tail (kernels/fold_update, kernel A1);
    # needs the dense wire to resolve packed, "auto" turns it on there.
    use_fused_tail: object = "auto"  # True | False | "auto"

    def validate(self):
        if self.mode not in ("dense", "queue", "auto"):
            raise ValueError(f"unknown BFS mode {self.mode!r}; "
                             "expected dense | queue | auto")
        if self.wire_format not in ("packed", "bytes", "compressed", "auto"):
            raise ValueError(f"unknown wire_format {self.wire_format!r}; "
                             "expected packed | bytes | compressed | auto")
        if self.sieve not in (True, False, "auto"):
            raise ValueError(f"unknown sieve setting {self.sieve!r}; "
                             "expected True | False | 'auto'")
        if self.use_fused_tail not in (True, False, "auto"):
            raise ValueError(
                f"unknown use_fused_tail setting {self.use_fused_tail!r}; "
                "expected True | False | 'auto'")
        # get_exchange raises a ValueError naming the registered strategies;
        # "auto" defers to the byte-model selection at plan time.
        for kind, name in (("dense", self.dense_exchange),
                           ("queue", self.queue_exchange),
                           ("expand_row", self.expand_exchange),
                           ("fold_col", self.fold_exchange),
                           ("expand_row_sparse", self.expand_sparse_exchange),
                           ("fold_col_sparse", self.fold_sparse_exchange)):
            if name != "auto":
                ex.get_exchange(kind, name)
        if self.queue_cap <= 0:
            raise ValueError(f"queue_cap must be positive ({self.queue_cap})")
        if self.max_levels < 0:
            raise ValueError(f"max_levels must be >= 0 ({self.max_levels})")


@dataclasses.dataclass
class BFSStats:
    """Host-side summary of one traversal (``BFSResult.stats()``)."""

    levels: int
    visited: int
    comm_bytes: float          # analytic, summed over levels, per chip
    overflowed: bool           # a queue level overflowed (never in dense mode)
    mode_counts: dict
    sieve_hits: int = 0        # candidates the visited-sieve dropped


def validate_sources(sources, n_logical: int,
                     max_sources: Optional[int] = None) -> np.ndarray:
    """Validate BFS source ids; returns them as a 1-D int64 array.

    Rejects ids outside ``[0, n_logical)`` and duplicates with a clear
    ValueError.
    """
    arr = np.atleast_1d(np.asarray(sources))
    if arr.ndim != 1:
        raise ValueError(f"sources must be a scalar or 1-D sequence, "
                         f"got shape {arr.shape}")
    if arr.size == 0:
        raise ValueError("sources must contain at least one vertex id")
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"sources must be integer vertex ids, "
                         f"got dtype {arr.dtype}")
    arr = arr.astype(np.int64)
    bad = arr[(arr < 0) | (arr >= n_logical)]
    if bad.size:
        raise ValueError(f"source ids {bad.tolist()} outside "
                         f"[0, {n_logical})")
    uniq, counts = np.unique(arr, return_counts=True)
    dup = uniq[counts > 1]
    if dup.size:
        raise ValueError(f"duplicate source ids {dup.tolist()}; each "
                         "column of a batched traversal needs a distinct "
                         "source")
    if max_sources is not None and arr.size > max_sources:
        raise ValueError(f"{arr.size} sources exceed the engine's "
                         f"compiled capacity of {max_sources}; build a "
                         "plan with a larger num_sources")
    return arr


def _owned_update(dist: torch.Tensor, own_cand: torch.Tensor,
                  level: int) -> torch.Tensor:
    """Owner-computes rule: only unvisited vertices take the new level.
    Updates ``dist`` in place (the engine's reused buffer); returns the
    uint8 newly-discovered mask."""
    new = (own_cand > 0) & (dist == INF)
    dist.masked_fill_(new, level)
    return new.to(torch.uint8)


def make_dense_level(part: Partition1D, s: int, mesh: LocalMesh, axis,
                     axes_sizes, dense_strategy: ex.ExchangeStrategy,
                     edge_rows, expand_fn: Optional[Callable] = None,
                     expand_emits_packed: bool = False,
                     fused: bool = False) -> Callable:
    """Build one dense BFS level over stacked shards.

    ``dense_level(frontier, dist, level, words) -> (new, level_bytes,
    new_words)`` takes the ``(p, shard, S)`` uint8 frontier, the same
    frontier packed as ``(p, W, S)`` words or ``None``, and the int32 dist
    (updated in place); it returns the ``(p, shard, S)`` uint8
    newly-discovered mask and, where the fused tail packed it, the same
    mask as words (else ``None``).

    ``edge_rows`` are ``frontier.dense_edge_index`` rows of the out-edge
    blocks (the default scatter-max expansion); ``expand_fn(frontier,
    words)`` replaces that expansion (the ``use_kernel`` bit-tile path)
    and, with ``expand_emits_packed``, hands the packed exchange its words
    directly.  ``fused`` (needs a packed dense wire) replaces the unpack
    -> update tail with kernel A1.
    """
    p, shard, n = part.p, part.shard_size, part.n
    dense_bytes = dense_strategy.bytes_model(n, p, s, 1, axes_sizes)
    packed_wire = dense_strategy.wire == "packed"

    def dense_level(frontier, dist, level, words=None):
        if expand_fn is not None:
            cand = expand_fn(frontier, words)
        else:
            cand = fr.expand_dense_edges(
                frontier.reshape(p * shard, s), *edge_rows,
                p * n).reshape(p, n, s)
        if packed_wire:
            # candidates stay packed through the exchange: pack once
            # (unless the kernel path emitted words), OR-merge, and only
            # the owned W-word slice is read back
            cwords = (cand if expand_fn is not None and expand_emits_packed
                      else fr.pack_bits(cand, n_blocks=p))
            merged = dense_strategy.impl(cwords, mesh, axis)  # (p, W, S)
            if fused:
                _, new, new_words = a1.fold_update(merged, dist, level,
                                                   inplace=True)
                return new, dense_bytes, new_words
            own = fr.unpack_bits(merged, shard)
        else:
            own = dense_strategy.impl(cand, mesh, axis)
        return _owned_update(dist, own, level), dense_bytes, None

    return dense_level


def run_dense_levels(dense_level: Callable, dist: torch.Tensor,
                     frontier: torch.Tensor, part: Partition1D,
                     max_levels: int):
    """Run levels until no shard discovers a vertex (or ``max_levels``).

    ``dist`` and ``frontier`` are the padded global ``(n, S)`` buffers;
    ``dist`` is updated in place.  Returns ``(levels, comm_bytes,
    level_seconds)``: the level count as the JAX loop reports it, the
    analytic per-chip bytes summed in float32 as the JAX loop sums them,
    and each level's host wall time (it ends in the level's sync).
    """
    p, shard, n = part.p, part.shard_size, part.n
    s = dist.shape[1]
    dist_sh = dist.view(p, shard, s)
    frontier = frontier.view(p, shard, s)
    bytes_acc = np.float32(0)
    level_seconds = []
    level, active, words = 1, True, None
    while active and level <= max_levels:
        t0 = time.perf_counter()
        new, b, words = dense_level(frontier, dist_sh, level, words)
        # padding vertices (ids >= n_logical) can never be visited
        new.view(n, s)[part.n_logical:] = 0
        dist[part.n_logical:] = INF
        active = bool(new.any())
        bytes_acc = np.float32(bytes_acc + np.float32(b))
        frontier = new
        level += 1
        level_seconds.append(time.perf_counter() - t0)
    return level - 1, float(bytes_acc), tuple(level_seconds)
