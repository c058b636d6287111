"""Level-synchronous BFS with 1-D (paper fig. 2) and 2-D partitioning —
the port of ``repro.core.bfs``'s level loops.

Every iteration of the level loop is one BFS level: local expansion
(computation step, paper §2.3), the owner exchange (communication step)
and the owner-side distance update.  The shards a mesh holds here run as
one stacked ``(local, ...)`` computation: all p of a ``LocalMesh``, one
of a ``DistMesh`` (``core.dist_mesh``, a rank a shard).  JAX's
``lax.while_loop`` becomes a Python loop over levels and each ``lax.cond``
a Python branch on a value read from the device.  The loop reads across
shards only through the mesh: the termination flag, the level statistics,
the overflow flag and the sieve's hits are per-shard values reduced by
the mesh's replicated ``psum`` / ``pmax`` (JAX's ``lax.psum``) before the
one read, so every rank takes the same branch.

Modes (``BFSOptions.mode``):
  * ``dense`` — bitmap frontier, candidate exchange by a ``dense``
    strategy; S sources at once.  One host read a level (termination).
  * ``queue`` — the paper's per-owner send buffers (S = 1), with the
    visited sieve, the compressed wire, and escalation of the whole level
    to dense when any shard's bucket or stream overflows.  Two host reads
    a level: the overflow predicate (with the sieve's hit count), then
    termination with the next level's frontier statistics, plus one
    read of the sources' statistics before the first level.
  * ``auto`` — direction-optimizing hybrid (Beamer et al.): per level
    bottom-up when the frontier is large, queue when its out-edges are
    few (S = 1 only), else dense.  The next level's frontier statistics
    are read with the termination flag, so dense and bottom-up levels
    keep one host read (queue levels two), plus one read of the sources'
    statistics before the first level.

The 2-D loop (``make_level_loop_2d``, over an ``r x c`` grid mesh) runs
the same three modes with a two-phase exchange a level — a gather over
the grid row, a fold over the grid column — and the same host reads; both
loops share the runner (``_level_runner``) and the bottom-up level.

Each level runs inside a ``bfs.level`` span and its parts inside
``bfs.expand``, ``bfs.fold`` and ``bfs.owner_update`` (``core.spans``;
recorded, and profiler ranges, only while the recorder is on), which
``analysis.trace_model`` reads.  A1, the fused fold tail, unpacks,
updates and re-packs in one kernel; it runs in ``bfs.owner_update``,
after the fold range's pack and exchange.

This module holds the options, source validation, the level loops and the
deprecated one-shot ``bfs()``; the public lifecycle (``plan -> compile ->
run``) lives in ``core/engine.py``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import exchange as ex
from repro_torch.core import frontier as fr
from repro_torch.core.mesh import LocalMesh
from repro_torch.core.partition import Partition1D, Partition2D
from repro_torch.core.spans import (EXPAND, FOLD, LEVEL, OWNER_UPDATE,
                                    span)
# the module, not the function: kernels.fold_update imports core.frontier,
# so importing it first runs core/__init__, which lands here half-way
from repro_torch.kernels import fold_update as a1

INF = fr.INF
#: a level's kinds, indexed as ``mode_counts`` counts them
LEVEL_KINDS = ("dense", "queue", "bottom_up")


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
        # audit: allow(RX004) -- a numpy array of the caller's ids
        raise ValueError(f"source ids {bad.tolist()} outside "
                         f"[0, {n_logical})")
    uniq, counts = np.unique(arr, return_counts=True)
    dup = uniq[counts > 1]
    if dup.size:
        # audit: allow(RX004) -- a numpy array of the caller's ids
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


def _pack_active(active: torch.Tensor, ids: torch.Tensor, width: int):
    """Each row's active ``ids``, in order, packed to the left of a ``(g,
    width)`` block, with the packed active mask and each row's count.

    Buckets, dedupe and overflow depend only on the order of the active
    entries, so they stay the unpacked formulation's bitwise while the
    sorts after this cost the frontier's edges, not the block's capacity.
    Entries past ``width`` drop (the caller checks the counts).  One scan
    over the flattened mask: a scan along the rows of a ``(g, e_cap)``
    array runs one thread block a row on the card.
    """
    g = active.shape[0]
    rank = active.view(-1).cumsum(0).view(g, -1)
    before = torch.cat([rank.new_zeros(1), rank[:-1, -1]])
    pos = rank - before[:, None] - 1
    pos = torch.where(active & (pos < width), pos, width)
    packed = ids.new_full((g, width + 1), -1).scatter_(1, pos, ids)
    act = active.new_zeros((g, width + 1)).scatter_(1, pos, active)
    return packed[:, :width], act[:, :width], rank[:, -1] - before


def _bottom_up_level_fn(local: int, shard: int, s: int, mesh: LocalMesh,
                        axis, in_rows, wire: str, level_bytes, fused: bool):
    """The bottom-up level: gather the frontier over ``axis`` (every
    shard, in chunk order) and check each owned vertex's in-edges
    (``in_rows``: ``frontier.bottom_up_edge_index`` rows for ``wire``) of
    the ``local`` shards held here."""

    def bottom_up_level(frontier, fwords, dist, level):
        with span(EXPAND):
            if wire == "packed":
                # gather the packed frontier and read source bits straight
                # out of the words; a fused plan gathers the carried words
                fw = fwords if fwords is not None else fr.pack_bits(frontier)
                fglob = ex.allgather_frontier(fw, mesh, axis)  # (., p*W, S)
            else:
                fglob = ex.allgather_frontier(frontier, mesh, axis)
            cand = fr.expand_bottom_up_edges(fglob, in_rows, local * shard)
        with span(OWNER_UPDATE):
            new = _owned_update(dist, cand.view(local, shard, s), level)
            return new, level_bytes, fr.pack_bits(new) if fused else None

    return bottom_up_level


def _level_runner(part, s: int, mode: str, e_total: int, opts: BFSOptions,
                  mesh: LocalMesh, dense_level: Callable,
                  queue_level: Callable,
                  bottom_up_level: Optional[Callable],
                  frontier_stats: Optional[Callable], fused: bool,
                  vwords) -> Callable:
    """The level loop shared by both partitions.

    Runs ``dense_level(frontier, fwords, dist, level) -> (new, bytes,
    nwords)``, ``queue_level(..., width) -> (new, bytes, nwords,
    overflowed, hits)`` or ``bottom_up_level(...)`` a level, by mode and,
    in ``auto``, by the rule on ``frontier_stats(frontier) -> (f_verts,
    f_edges, width)``: the frontier's pairs over every column, the
    out-edges of column 0's frontier, and the most active edges any shard
    (or grid cell) can hold, read from the device with the termination
    flag.  Every read of the device goes through ``mesh.host_read`` of a
    value reduced over every shard, and the loop tells
    ``mesh.enter_level`` which level it runs and as what.  Returns
    ``run(dist, frontier, max_levels)`` (see ``make_level_loop``).
    """
    shard = part.shard_size
    local = len(mesh.local_shards)
    everyone = tuple(mesh.axis_names)
    queue_edge_cutoff = max(1, int(opts.queue_threshold * e_total))
    bottom_up_cutoff = max(1, int(opts.bottom_up_threshold * part.n_logical))
    # padding vertices (ids >= n_logical) fill the tail of the last
    # shards; the local rows from here on are padding
    pad_from = min(max(part.n_logical - mesh.local_shards[0] * shard, 0),
                   local * shard)

    def run(dist, frontier, max_levels):
        dist_sh = dist.view(local, shard, s)
        frontier = frontier.view(local, shard, s)
        bytes_acc = np.float32(0)
        overflowed, modes, hits_acc = False, [0, 0, 0], 0
        level, active, fwords = 1, True, None
        if mode != "dense":
            mesh.enter_level(0, "sources")
            f_verts, f_edges, width = frontier_stats(frontier)
        while active and level <= max_levels:
            with span(LEVEL):
                ovf, hits = False, 0
                if mode == "auto":
                    if f_verts > bottom_up_cutoff:
                        which = 2
                    elif s == 1 and f_edges < queue_edge_cutoff:
                        which = 1
                    else:
                        which = 0
                else:
                    which = 1 if mode == "queue" else 0
                mesh.enter_level(level, LEVEL_KINDS[which])
                if which == 0:
                    new, b, nwords = dense_level(frontier, fwords, dist_sh,
                                                 level)
                elif which == 1:
                    new, b, nwords, ovf, hits = queue_level(
                        frontier, fwords, dist_sh, level, width)
                else:
                    new, b, nwords = bottom_up_level(frontier, fwords,
                                                     dist_sh, level)
                modes[which] += 1
                # padding vertices can never be visited
                new.view(local * shard, s)[pad_from:] = 0
                dist[pad_from:] = INF
                if fused:
                    # the next packed generation, pad bits cleared to match
                    # the masked byte frontier
                    fwords = nwords & vwords
                if mode != "dense":
                    f_verts, f_edges, width = frontier_stats(new)
                    active = f_verts > 0
                else:
                    found = mesh.pmax(new.view(local, -1).any(1).long(),
                                      everyone)
                    # audit: allow(RX004) -- budget: a dense level's one read
                    active = bool(mesh.host_read(found[0]))
                bytes_acc = np.float32(bytes_acc + b)
                overflowed |= ovf
                hits_acc += hits
                frontier = new
                level += 1
        mesh.enter_level(0, "outside")
        return (level - 1, float(bytes_acc), overflowed, tuple(modes),
                hits_acc)

    return run


def valid_words(part, mesh: LocalMesh) -> torch.Tensor:
    """(local, W, 1) packed mask of the real (non-padding) vertices of the
    shards ``mesh`` holds here."""
    shard, held = part.shard_size, mesh.local_shards
    valid = (torch.arange(held[0] * shard, (held[-1] + 1) * shard,
                          device=mesh.device).view(len(held), shard)
             < part.n_logical)
    return fr.pack_bits(valid[..., None].to(torch.uint8))


def out_edge_state(src_local: torch.Tensor, dst_global: torch.Tensor,
                   shard: int) -> tuple:
    """What queue levels and the ``auto`` statistics read of the 1-D
    out-edge blocks: ``(src_idx, dst_global, out_valid, out_deg)`` — the
    int64 source rows (padding at 0), the targets, the validity mask and
    each local vertex's valid out-edges (the auto rule's ``f_edges`` is
    the frontier's column 0 weighted by them)."""
    out_valid = dst_global >= 0
    src_idx = torch.where(out_valid, src_local.long(), 0)
    out_deg = torch.zeros((src_local.shape[0], shard), dtype=torch.int64,
                          device=src_local.device).scatter_add_(
        1, src_idx, out_valid.long())
    return src_idx, dst_global, out_valid, out_deg


def out_edge_state_2d(src_rowlocal: torch.Tensor, dst_fold: torch.Tensor,
                      part2: Partition2D, mesh: LocalMesh,
                      col_axis) -> tuple:
    """The 2-D twin of ``out_edge_state`` over the cells ``mesh`` holds:
    ``(src_idx, dst_fold, out_valid, out_deg_col)``, where
    ``out_deg_col`` ``(local, b, c)`` counts each owned vertex's out-edges
    into each grid column.  Cell (i, j)'s sources are row block i's, so
    each cell counts its edges by row-local source into its own column,
    and a reduce-scatter over ``col_axis`` (the cells of grid row i)
    hands each chunk of the row block its sources' counts: a cell's
    active edges are its row's frontier weighted by its column's."""
    b, c = part2.shard_size, part2.c
    local = src_rowlocal.shape[0]
    out_valid = dst_fold >= 0
    src_idx = torch.where(out_valid, src_rowlocal.long(), 0)
    col = mesh.axis_index(col_axis)[:, None]                    # (local, 1)
    slot = (src_idx * c + col).view(local, -1)
    counts = torch.zeros((local, c * b * c), dtype=torch.int64,
                         device=src_rowlocal.device).scatter_add_(
        1, slot, out_valid.long())
    out_deg_col = mesh.psum_scatter(counts, col_axis).view(local, b, c)
    return src_idx, dst_fold, out_valid, out_deg_col


def _reduced_stats(mesh: LocalMesh, axis, frontier: torch.Tensor,
                   f_edges: torch.Tensor) -> tuple:
    """``(f_verts, f_edges, width)`` read in one host read: the frontier's
    pairs and the active edges (``f_edges``, one a shard or grid cell
    held here) summed over every shard, and the most active edges any
    one holds (at least 1)."""
    local = frontier.shape[0]
    f_verts = frontier.reshape(local, -1).sum(1, dtype=torch.int64)
    total = mesh.psum(torch.stack([f_verts, f_edges], 1), axis)
    most = mesh.pmax(f_edges[:, None], axis)
    # audit: allow(RX004) -- budget: one read a level (stats)
    stats = mesh.host_read(torch.cat([total[0], most[0]]))
    return stats[0], stats[1], max(1, stats[2])


def make_level_loop(part: Partition1D, s: int, e_total: int,
                    mesh: LocalMesh, axis, axes_sizes, opts: BFSOptions,
                    dense_strategy: ex.ExchangeStrategy,
                    queue_strategy: ex.ExchangeStrategy, edge_rows,
                    out_edges=None, in_rows=None,
                    expand_fn: Optional[Callable] = None,
                    expand_emits_packed: bool = False,
                    bottom_up_wire: str = "bytes", sieve: bool = False,
                    fused: bool = False, vwords=None) -> Callable:
    """Build the 1-D level loop of one engine over stacked shards.

    Returns ``run(dist, frontier, max_levels)``, which runs levels on the
    ``(local * shard, S)`` buffers of the shards the mesh holds here (the
    padded global ``(n, S)`` ones on a ``LocalMesh``; ``dist`` updated in
    place) until no shard discovers a vertex (or ``max_levels``) and
    returns ``(levels, comm_bytes, overflowed, mode_counts, sieve_hits)``:
    the level count as the JAX loop reports it, the analytic per-chip
    bytes summed in float32 as the JAX loop sums them, whether a queue
    level escalated to dense, the (dense, queue, bottom_up) level counts
    and the candidates the sieve dropped.  Each level's host time is its
    ``bfs.level`` span (``core.spans``).

    ``edge_rows`` are ``frontier.dense_edge_index`` rows of the out-edge
    blocks (the scatter-max expansion of a bytes wire);
    ``expand_fn(frontier, words)`` replaces that expansion
    (``kernels.expand_dense`` over the out-edge CSR on a packed wire, the
    ``use_kernel`` bit-tile path) and, with ``expand_emits_packed``, hands
    the packed exchange its words directly.  ``out_edges`` — ``out_edge_state`` of the ``(p, e_cap)``
    ``src_local`` and ``dst_global`` blocks — feed queue levels and the
    ``auto`` statistics; ``in_rows`` are ``frontier.bottom_up_edge_index``
    rows for the resolved ``bottom_up_wire`` (``auto`` only).  ``fused``
    (needs a packed dense wire) replaces the dense unpack -> update tail
    with kernel A1 and carries the packed frontier generation between
    levels, which the packed bottom-up gather reads.  ``vwords`` is
    ``valid_words(part, mesh)``, made here when not given.
    """
    p, shard, n = part.p, part.shard_size, part.n
    local = len(mesh.local_shards)
    cap = opts.queue_cap
    dev = mesh.device
    itemsize = 1  # uint8 masks (the "bytes" wire format)
    # compressed queue wire: bucket row j encodes ids relative to j*shard
    use_compressed = queue_strategy.wire == "compressed"
    q_byte_cap = fr.compressed_capacity(cap, shard)
    sv_bits, sv_bucket, sv_words = fr.sieve_layout(shard)
    sieve_gather_bytes = float((p - 1) * sv_words * 4) if sieve else 0.0
    # each level's bytes as the float32 the JAX loop adds
    dense_bytes = np.float32(dense_strategy.bytes_model(n, p, s, itemsize,
                                                        axes_sizes))
    escalated_bytes = np.float32(dense_bytes + np.float32(sieve_gather_bytes))
    queue_bytes = np.float32(queue_strategy.bytes_model(
        p, cap, 4, cap / shard) + sieve_gather_bytes)
    bottom_up_bytes = np.float32(ex.bottomup_level_bytes(
        n, p, s, itemsize, wire=bottom_up_wire))
    packed_wire = dense_strategy.wire == "packed"
    me = mesh.axis_index(axis)                              # (local,)
    # bucket row j's base (the compressed queue wire), over all p owners
    base = torch.arange(p, device=dev, dtype=torch.int32)[:, None] * shard
    frontier_stats = None
    if out_edges is not None:
        src_idx, dst_global, out_valid, out_deg = out_edges

        def frontier_stats(frontier):
            """One host read: the frontier's pairs over every column, the
            valid out-edges from column 0's frontier over every shard, and
            the most any shard holds (a queue level's active edges)."""
            f_edges = (frontier[..., 0].long() * out_deg).sum(1)
            return _reduced_stats(mesh, axis, frontier, f_edges)

    def dense_level(frontier, fwords, dist, level):
        with span(EXPAND):
            if expand_fn is not None:
                cand = expand_fn(frontier, fwords)
            else:
                cand = fr.expand_dense_edges(
                    frontier.reshape(local * shard, s), *edge_rows,
                    local * n).reshape(local, n, s)
        with span(FOLD):
            if packed_wire:
                # candidates stay packed through the exchange: pack once
                # (unless the kernel path emitted words), OR-merge, and
                # only the owned W-word slice is read back
                cwords = (cand if expand_fn is not None
                          and expand_emits_packed
                          else fr.pack_bits(cand, n_blocks=p))
                merged = dense_strategy.impl(cwords, mesh, axis)  # (p, W, S)
                if not fused:
                    own = fr.unpack_bits(merged, shard)
            else:
                own = dense_strategy.impl(cand, mesh, axis)
        with span(OWNER_UPDATE):
            if fused:
                # A1 unpacks, updates and re-packs in one pass
                _, new, new_words = a1.fold_update(merged, dist, level,
                                                   inplace=True)
                return new, dense_bytes, new_words
            return _owned_update(dist, own, level), dense_bytes, None

    def queue_level(frontier, fwords, dist, level, width):
        with span(EXPAND):
            active = (frontier[..., 0].gather(1, src_idx) > 0) & out_valid
            # each shard's active edges packed to the left of a (p, width)
            # block (width: the most any shard has, read with the
            # statistics)
            dst, active, _ = _pack_active(active, dst_global, width)
            hits = torch.zeros((local,), dtype=torch.int64, device=dev)
            if sieve:
                # replicate each shard's coarse visited summary and drop
                # candidates whose whole bucket is already visited
                own_sum = fr.sieve_summary(dist[..., 0], sv_bits, sv_bucket)
                gsum = mesh.all_gather(own_sum, axis).flatten(1, 2)
                drop = fr.sieve_lookup(gsum, dst, shard, sv_bits, sv_bucket,
                                       sv_words) & active
                hits = drop.sum(1)
                active = active & ~drop
            buckets, local_mask, _, overflow = fr.build_queue_buckets(
                dst, active, part, me, cap, local_update=opts.local_update,
                dedupe=opts.dedupe)
            if use_compressed:
                rel = torch.where(buckets >= 0, buckets - base, -1)
                payload, enc_ovf = fr.encode_delta_varint(rel, q_byte_cap,
                                                          shard)
                overflow = overflow | enc_ovf.any(-1)
            # Exactness: if any shard's bucket (or compressed stream)
            # overflowed, the whole level runs densely instead
            flags = mesh.psum(torch.stack([overflow.long(), hits], 1), axis)
            # audit: allow(RX004) -- budget: a queue level's second read
            ovf, hits = mesh.host_read(flags[0])
        if ovf:
            mesh.enter_level(level, "escalated")
            new, _, nwords = dense_level(frontier, None, dist, level)
            # the sieve gather (if any) already ran before escalation
            return new, escalated_bytes, nwords, True, hits
        with span(FOLD):
            if use_compressed:
                recv = queue_strategy.impl(payload, mesh, axis)  # (p, p, B)
                rec_ids = fr.decode_delta_varint(recv, cap, shard)
                rec_ids = torch.where(rec_ids >= 0,
                                      rec_ids + me[:, None, None] * shard, -1)
            else:
                rec_ids = queue_strategy.impl(buckets, mesh, axis)
        with span(OWNER_UPDATE):
            own = torch.maximum(fr.apply_queue(rec_ids, me, shard),
                                local_mask)
            new = _owned_update(dist, own[..., None], level)
            nwords = fr.pack_bits(new) if fused else None
            return new, queue_bytes, nwords, False, hits

    bottom_up_level = _bottom_up_level_fn(local, shard, s, mesh, axis,
                                          in_rows, bottom_up_wire,
                                          bottom_up_bytes, fused)
    return _level_runner(part, s, opts.mode, e_total, opts, mesh,
                         dense_level, queue_level, bottom_up_level,
                         frontier_stats, fused,
                         vwords if vwords is not None
                         else valid_words(part, mesh))


def make_level_loop_2d(part2: Partition2D, s: int, e_total: int,
                       mesh: LocalMesh, row_axis, col_axis, opts: BFSOptions,
                       expand_strategy: ex.ExchangeStrategy,
                       fold_strategy: ex.ExchangeStrategy,
                       expand_sparse_strategy: ex.ExchangeStrategy,
                       fold_sparse_strategy: ex.ExchangeStrategy, edge_rows,
                       out_edges=None, in_rows=None,
                       bottom_up_wire: str = "bytes", sieve: bool = False,
                       fused: bool = False, vwords=None) -> Callable:
    """Build the 2-D level loop (the port of ``_make_shard_fn_2d``) over
    the stacked cells of an ``r x c`` grid mesh; returns ``run`` as
    ``make_level_loop`` does.

    A dense level is expand -> local edge scatter -> fold -> owner update:
    gather each cell's ``(b, S)`` frontier chunk over ``col_axis`` into
    its grid row's ``(c*b, S)`` frontier, scatter the cell's edges into
    the transposed ``(r*b, S)`` fold layout, merge the fold blocks over
    ``row_axis`` (each cell receives its owned ``(b, S)`` merge) and
    update.  ``fused`` (fold wire packed) folds the words, runs A1 on the
    merged ``(p, W, S)`` words and carries the packed generation, which
    the next level's packed expand gathers and
    ``frontier.expand_dense_2d_packed`` reads bit by bit (``edge_rows``:
    its ``dense_2d_packed_edge_index`` rows when the expand wire is packed
    too, else ``dense_edge_index`` rows of the row block).

    A queue level (S = 1) gathers the frontier as ids over the row
    (``pack_frontier_ids``, optionally compressed), sieves the candidates
    against the visited summary gathered over both axes, buckets them by
    owner row rank (``build_queue_buckets_2d``) and folds the buckets
    (optionally compressed, row ``rr`` relative to ``rr*b``); any cell's
    frontier-pack, bucket or codec overflow runs the level densely, at the
    dense bytes plus the sparse expand and sieve bytes already spent.  A
    bottom-up level gathers the frontier over both axes.  ``out_edges``
    — ``out_edge_state_2d`` of the ``(p, e_cap)`` ``src_rowlocal`` and
    ``dst_fold`` blocks — feed queue levels and the statistics;
    ``in_rows`` the bottom-up level.
    """
    r, c, b, p = part2.r, part2.c, part2.shard_size, part2.p
    n, fold_len, cap = part2.n, part2.fold_size, opts.queue_cap
    local = len(mesh.local_shards)
    dev = mesh.device
    grid_axes = (row_axis, col_axis)
    # both compressed sparse phases ship ids from [0, b) (expand: local
    # frontier ids; fold: bucket row rr relative to rr*b)
    use_comp_expand = expand_sparse_strategy.wire == "compressed"
    use_comp_fold = fold_sparse_strategy.wire == "compressed"
    g_byte_cap = fr.compressed_capacity(cap, b)
    g_density = cap / b
    sv_bits, sv_bucket, sv_words = fr.sieve_layout(b)
    # each level's bytes as the float32 the JAX loop adds
    sieve_gather_bytes = np.float32((p - 1) * sv_words * 4 if sieve else 0.0)
    dense_bytes = np.float32(expand_strategy.bytes_model(n, r, c, s, 1)
                             + fold_strategy.bytes_model(n, r, c, s, 1))
    expand_sparse_bytes = np.float32(expand_sparse_strategy.bytes_model(
        r, c, cap, 4, g_density))
    sparse_bytes = (expand_sparse_bytes + sieve_gather_bytes + np.float32(
        fold_sparse_strategy.bytes_model(r, c, cap, 4, g_density)))
    escalated_bytes = dense_bytes + expand_sparse_bytes + sieve_gather_bytes
    bottom_up_bytes = np.float32(ex.bottomup_level_bytes(
        n, p, s, 1, wire=bottom_up_wire))
    packed_expand = expand_strategy.wire == "packed"
    me_row = mesh.axis_index(row_axis)                      # (local,)
    me_col = mesh.axis_index(col_axis)
    frontier_stats = None
    if out_edges is not None:
        src_idx, dst_fold, out_valid, out_deg_col = out_edges
        rr_base = torch.arange(r, device=dev, dtype=torch.int32)[:, None] * b

        def frontier_stats(frontier):
            """One host read: the frontier's pairs over every column, the
            active edges from column 0's frontier over every grid cell,
            and the most any cell holds.  Chunk (i, j')'s out-edges into
            each grid column sum over grid row i's chunks (a psum over
            ``col_axis``) to the counts of cells (i, :)."""
            per_chunk = (frontier[..., 0, None].long() * out_deg_col).sum(1)
            row = mesh.psum(per_chunk, col_axis)                # (local, c)
            return _reduced_stats(mesh, grid_axes, frontier,
                                  row.gather(1, me_col[:, None])[:, 0])

    def expand_row_bytes(frow):     # (local, c*b, S) -> (local*r*b, S)
        return fr.expand_dense_edges(frow.reshape(local * c * b, s),
                                     *edge_rows, local * fold_len)

    def dense_level(frontier, fwords, dist, level):
        with span(EXPAND):
            if packed_expand:
                # fused plans gather the carried generation and read source
                # bits straight from the words (expand_dense_2d_packed: a
                # word gather and scatter-max over the edge rows); unfused
                # ones pack here and unpack the c gathered segments
                payload = (fwords if fwords is not None
                           else fr.pack_bits(frontier))
                fw = expand_strategy.impl(payload, mesh, col_axis)
                if fused:
                    cand = fr.expand_bottom_up_edges(fw, edge_rows,
                                                     local * fold_len)
                else:
                    cand = expand_row_bytes(fr.unpack_bits(fw, b,
                                                           n_blocks=c))
            else:
                cand = expand_row_bytes(expand_strategy.impl(frontier, mesh,
                                                             col_axis))
            cand = cand.view(local, fold_len, s)
        with span(FOLD):
            if fold_strategy.wire == "packed":
                cw = fold_strategy.impl(fr.pack_bits(cand, n_blocks=r), mesh,
                                        row_axis)               # (p, W, S)
                if not fused:
                    own = fr.unpack_bits(cw, b)
            else:
                own = fold_strategy.impl(cand, mesh, row_axis)  # (p, b, S)
        with span(OWNER_UPDATE):
            if fused:
                # A1 unpacks, updates and re-packs in one pass
                _, new, nwords = a1.fold_update(cw, dist, level, inplace=True)
                return new, dense_bytes, nwords
            return _owned_update(dist, own, level), dense_bytes, None

    def sieve_drop(dst, active, dist):
        """Candidates whose whole summary bucket is visited: fold index
        ``rr*b + loc`` targets chunk ``rr*c + me_col``, and the summary
        gather over both axes is in chunk order."""
        own_sum = fr.sieve_summary(dist[..., 0], sv_bits, sv_bucket)
        gsum = mesh.all_gather(own_sum, grid_axes).flatten(1, 2)
        df = torch.where(active, dst.long(), 0)
        rr = torch.div(df, b, rounding_mode="floor")
        gid = (rr * c + me_col[:, None]) * b + (df - rr * b)
        return fr.sieve_lookup(gsum, gid, b, sv_bits, sv_bucket,
                               sv_words) & active

    def queue_level(frontier, fwords, dist, level, width):
        with span(EXPAND):
            ids, _, overflow = fr.pack_frontier_ids(frontier, cap)  # (p, cap)
            if use_comp_expand:
                pay, enc_ovf = fr.encode_delta_varint(ids, g_byte_cap, b)
                overflow = overflow | enc_ovf
                all_pay = expand_sparse_strategy.impl(pay, mesh, col_axis)
                all_ids = fr.decode_delta_varint(
                    all_pay.view(local, c, g_byte_cap), cap, b).view(
                        local, c * cap)
            else:
                all_ids = expand_sparse_strategy.impl(ids, mesh, col_axis)
            frow = fr.unpack_row_frontier(all_ids, c, b)    # (., c*b, 1)
            full = (frow[..., 0].gather(1, src_idx) > 0) & out_valid
            # width bounds each cell's active edges from the true
            # frontier; a truncated compressed frontier can decode to
            # more, but only where its overflow escalates the level
            dst, active, counts = _pack_active(full, dst_fold, width)
            over = counts > width
            hits = torch.zeros((local,), dtype=torch.int64, device=dev)
            if sieve:
                drop = sieve_drop(dst, active, dist)
                hits = drop.sum(1)
                active = active & ~drop
            buckets, local_mask, _, bucket_ovf = fr.build_queue_buckets_2d(
                dst, active, part2, me_row, cap,
                local_update=opts.local_update, dedupe=opts.dedupe)
            if use_comp_fold:
                rel = torch.where(buckets >= 0, buckets - rr_base, -1)
                fpay, fenc_ovf = fr.encode_delta_varint(rel, g_byte_cap, b)
                bucket_ovf = bucket_ovf | fenc_ovf.any(-1)
            # Exactness: if any cell's frontier pack, bucket or compressed
            # stream overflowed, the whole level runs densely instead
            flags = mesh.psum(torch.stack(
                [(overflow | bucket_ovf).long(), hits, over.long()], 1),
                grid_axes)
            # audit: allow(RX004) -- budget: a queue level's second read
            ovf, hits, over = mesh.host_read(flags[0])
            if over:
                if not ovf:
                    raise RuntimeError("a queue level's active edges exceed "
                                       "the width its statistics bound")
                if sieve:     # the hits of every active edge, as JAX counts
                    all_hits = mesh.psum(
                        sieve_drop(dst_fold, full, dist).sum(1), grid_axes)
                    # audit: allow(RX004) -- an escalated level's third read
                    hits = mesh.host_read(all_hits[0])
        if ovf:
            mesh.enter_level(level, "escalated")
            new, bb, nwords = dense_level(frontier, fwords, dist, level)
            # the sparse expand (and sieve gather) above already ran
            return new, escalated_bytes, nwords, True, hits
        with span(FOLD):
            if use_comp_fold:
                recvp = fold_sparse_strategy.impl(fpay, mesh, row_axis)
                rec = fr.decode_delta_varint(recvp, cap, b)   # (., r, cap)
                rec = torch.where(rec >= 0, rec + me_row[:, None, None] * b,
                                  -1)
            else:
                rec = fold_sparse_strategy.impl(buckets, mesh, row_axis)
        with span(OWNER_UPDATE):
            own = torch.maximum(fr.apply_queue(rec, me_row, b), local_mask)
            new = _owned_update(dist, own[..., None], level)
            nwords = fr.pack_bits(new) if fused else None
            return new, sparse_bytes, nwords, False, hits

    bottom_up_level = _bottom_up_level_fn(local, b, s, mesh, grid_axes,
                                          in_rows, bottom_up_wire,
                                          bottom_up_bytes, fused)
    return _level_runner(part2, s, opts.mode, e_total, opts, mesh,
                         dense_level, queue_level, bottom_up_level,
                         frontier_stats, fused,
                         vwords if vwords is not None
                         else valid_words(part2, mesh))


def bfs(graph, sources, mesh: Optional[LocalMesh] = None, axis=None,
        opts: BFSOptions = BFSOptions(), device=None):
    """One-shot BFS from ``sources`` (int or sequence -> batched).

    .. deprecated::
        ``bfs()`` is a thin wrapper over the compile-once lifecycle —
        ``plan(graph, opts, mesh=...).compile().run(sources)`` — kept for
        call sites of the JAX package's ``bfs()``.  Engines resolve
        through the process-wide shared ``EngineCache``
        (``serve.engine_cache.default_engine_cache``), so repeated calls
        amortize the compile and share engines with the serving paths;
        new code should hold a ``BFSEngine`` directly.  ``device`` is
        ``plan()``'s (CUDA unless given, when ``mesh`` names none).

    Returns (dist, stats): dist is (n_logical, S) int32 with INF for
    unreachable vertices; stats is a BFSStats.
    """
    # deferred: the engine imports this module, the cache the engine
    from repro_torch.core import engine as _engine
    from repro_torch.serve.engine_cache import default_engine_cache

    warnings.warn(
        "repro_torch.core.bfs.bfs() is deprecated; use "
        "plan(graph, opts, mesh=...).compile().run(sources)",
        DeprecationWarning, stacklevel=2)
    src_arr = validate_sources(sources, graph.part.n_logical)
    pl = _engine.plan(graph, opts, mesh=mesh, axis=axis,
                      num_sources=int(src_arr.shape[0]), device=device)
    eng = default_engine_cache().get_or_compile(pl)
    eng.settle()         # a shared engine: read its last result back first
    res = eng.run(src_arr)
    return res.dist_host, res.stats()
