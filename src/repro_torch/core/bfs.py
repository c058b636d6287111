"""Level-synchronous BFS with 1-D (paper fig. 2) and 2-D partitioning —
the port of ``repro.core.bfs``'s level loops.

Every iteration of the level loop is one BFS level: local expansion
(computation step, paper §2.3), the owner exchange (communication step)
and the owner-side distance update.  The p shards of a ``LocalMesh`` run
as one stacked ``(p, ...)`` computation.  JAX's ``lax.while_loop`` becomes
a Python loop over levels and each ``lax.cond`` a Python branch on a value
read from the device.

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

This module holds the options, source validation and the level loops; the
public lifecycle (``plan -> compile -> run``) lives in ``core/engine.py``.
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
from repro_torch.core.partition import Partition1D, Partition2D
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


def _bottom_up_level_fn(p: int, shard: int, s: int, mesh: LocalMesh, axis,
                        in_rows, wire: str, level_bytes, fused: bool):
    """The bottom-up level: gather the frontier over ``axis`` (every
    shard, in chunk order) and check each owned vertex's in-edges
    (``in_rows``: ``frontier.bottom_up_edge_index`` rows for ``wire``)."""

    def bottom_up_level(frontier, fwords, dist, level):
        if wire == "packed":
            # gather the packed frontier and read source bits straight
            # out of the words; a fused plan gathers the carried words
            fw = fwords if fwords is not None else fr.pack_bits(frontier)
            fglob = ex.allgather_frontier(fw, mesh, axis)  # (p, p*W, S)
        else:
            fglob = ex.allgather_frontier(frontier, mesh, axis)  # (p, n, S)
        cand = fr.expand_bottom_up_edges(fglob, in_rows, p * shard)
        new = _owned_update(dist, cand.view(p, shard, s), level)
        return new, level_bytes, fr.pack_bits(new) if fused else None

    return bottom_up_level


def _level_runner(part, s: int, mode: str, e_total: int, opts: BFSOptions,
                  dense_level: Callable, queue_level: Callable,
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
    flag.  Returns ``run(dist, frontier, max_levels)`` (see
    ``make_level_loop``).
    """
    p, shard, n = part.p, part.shard_size, part.n
    queue_edge_cutoff = max(1, int(opts.queue_threshold * e_total))
    bottom_up_cutoff = max(1, int(opts.bottom_up_threshold * part.n_logical))

    def run(dist, frontier, max_levels):
        dist_sh = dist.view(p, shard, s)
        frontier = frontier.view(p, shard, s)
        bytes_acc = np.float32(0)
        overflowed, modes, hits_acc, level_seconds = False, [0, 0, 0], 0, []
        level, active, fwords = 1, True, None
        if mode != "dense":
            f_verts, f_edges, width = frontier_stats(frontier)
        while active and level <= max_levels:
            t0 = time.perf_counter()
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
            if which == 0:
                new, b, nwords = dense_level(frontier, fwords, dist_sh, level)
            elif which == 1:
                new, b, nwords, ovf, hits = queue_level(
                    frontier, fwords, dist_sh, level, width)
            else:
                new, b, nwords = bottom_up_level(frontier, fwords, dist_sh,
                                                 level)
            modes[which] += 1
            # padding vertices (ids >= n_logical) can never be visited
            new.view(n, s)[part.n_logical:] = 0
            dist[part.n_logical:] = INF
            if fused:
                # the next packed generation, pad bits cleared to match
                # the masked byte frontier
                fwords = nwords & vwords
            if mode != "dense":
                f_verts, f_edges, width = frontier_stats(new)
                active = f_verts > 0
            else:
                active = bool(fr.frontier_nonzero(new))
            bytes_acc = np.float32(bytes_acc + b)
            overflowed |= ovf
            hits_acc += hits
            frontier = new
            level += 1
            level_seconds.append(time.perf_counter() - t0)
        return (level - 1, float(bytes_acc), overflowed, tuple(modes),
                hits_acc, tuple(level_seconds))

    return run


def _valid_words(part, dev) -> torch.Tensor:
    """(p, W, 1) packed mask of the real (non-padding) vertices."""
    valid = (torch.arange(part.n, device=dev).view(part.p, part.shard_size)
             < part.n_logical)
    return fr.pack_bits(valid[..., None].to(torch.uint8))


def make_level_loop(part: Partition1D, s: int, e_total: int,
                    mesh: LocalMesh, axis, axes_sizes, opts: BFSOptions,
                    dense_strategy: ex.ExchangeStrategy,
                    queue_strategy: ex.ExchangeStrategy, edge_rows,
                    out_edges=None, in_rows=None,
                    expand_fn: Optional[Callable] = None,
                    expand_emits_packed: bool = False,
                    bottom_up_wire: str = "bytes", sieve: bool = False,
                    fused: bool = False) -> Callable:
    """Build the 1-D level loop of one engine over stacked shards.

    Returns ``run(dist, frontier, max_levels)``, which runs levels on the
    padded global ``(n, S)`` buffers (``dist`` updated in place) until no
    shard discovers a vertex (or ``max_levels``) and returns ``(levels,
    comm_bytes, overflowed, mode_counts, sieve_hits, level_seconds)``:
    the level count as the JAX loop reports it, the analytic per-chip
    bytes summed in float32 as the JAX loop sums them, whether a queue
    level escalated to dense, the (dense, queue, bottom_up) level counts,
    the candidates the sieve dropped, and each level's host wall time.

    ``edge_rows`` are ``frontier.dense_edge_index`` rows of the out-edge
    blocks (the default scatter-max expansion); ``expand_fn(frontier,
    words)`` replaces that expansion (the ``use_kernel`` bit-tile path)
    and, with ``expand_emits_packed``, hands the packed exchange its words
    directly.  ``out_edges`` — the ``(p, e_cap)`` ``src_local`` and
    ``dst_global`` blocks — feed queue levels and the ``auto`` statistics;
    ``in_rows`` are ``frontier.bottom_up_edge_index`` rows for the
    resolved ``bottom_up_wire`` (``auto`` only).  ``fused`` (needs a
    packed dense wire) replaces the dense unpack -> update tail with
    kernel A1 and carries the packed frontier generation between levels,
    which the packed bottom-up gather reads.
    """
    p, shard, n = part.p, part.shard_size, part.n
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
    me = mesh.axis_index(axis)                                  # (p,)
    base = torch.arange(p, device=dev, dtype=torch.int32)[:, None] * shard
    frontier_stats = None
    if out_edges is not None:
        src_local, dst_global = out_edges
        out_valid = dst_global >= 0
        src_idx = torch.where(out_valid, src_local.long(), 0)
        # valid out-edges of each local vertex: the auto rule's f_edges is
        # the frontier's column 0 weighted by them
        out_deg = torch.zeros((p, shard), dtype=torch.int64,
                              device=dev).scatter_add_(1, src_idx,
                                                       out_valid.long())

        def frontier_stats(frontier):
            """One host read: the frontier's pairs over every column and
            each shard's valid out-edges from column 0's frontier (a
            queue level's active edges)."""
            f_edges = (frontier[..., 0].long() * out_deg).sum(1)
            stats = torch.cat([frontier.sum(dtype=torch.int64).view(1),
                               f_edges]).tolist()
            return stats[0], sum(stats[1:]), max(1, max(stats[1:]))

    def dense_level(frontier, fwords, dist, level):
        if expand_fn is not None:
            cand = expand_fn(frontier, fwords)
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

    def queue_level(frontier, fwords, dist, level, width):
        active = (frontier[..., 0].gather(1, src_idx) > 0) & out_valid
        # each shard's active edges packed to the left of a (p, width)
        # block (width: the most any shard has, read with the statistics)
        dst, active, _ = _pack_active(active, dst_global, width)
        hits = torch.zeros((), dtype=torch.int64, device=dev)
        if sieve:
            # replicate each shard's coarse visited summary and drop
            # candidates whose whole bucket is already visited
            own_sum = fr.sieve_summary(dist[..., 0], sv_bits, sv_bucket)
            gsum = mesh.all_gather(own_sum, axis).flatten(1, 2)
            drop = fr.sieve_lookup(gsum, dst, shard, sv_bits, sv_bucket,
                                   sv_words) & active
            hits = drop.sum()
            active = active & ~drop
        buckets, local_mask, _, overflow = fr.build_queue_buckets(
            dst, active, part, me, cap, local_update=opts.local_update,
            dedupe=opts.dedupe)
        if use_compressed:
            rel = torch.where(buckets >= 0, buckets - base, -1)
            payload, enc_ovf = fr.encode_delta_varint(rel, q_byte_cap, shard)
            overflow = overflow | enc_ovf.any(-1)
        # Exactness: if any shard's bucket (or compressed stream)
        # overflowed, the whole level runs densely instead
        ovf, hits = torch.stack([overflow.any().long(), hits]).tolist()
        if ovf:
            new, _, nwords = dense_level(frontier, None, dist, level)
            # the sieve gather (if any) already ran before escalation
            return new, escalated_bytes, nwords, True, hits
        if use_compressed:
            recv = queue_strategy.impl(payload, mesh, axis)  # (p, p, bytes)
            rec_ids = fr.decode_delta_varint(recv, cap, shard)
            rec_ids = torch.where(rec_ids >= 0,
                                  rec_ids + me[:, None, None] * shard, -1)
        else:
            rec_ids = queue_strategy.impl(buckets, mesh, axis)
        own = torch.maximum(fr.apply_queue(rec_ids, me, shard), local_mask)
        new = _owned_update(dist, own[..., None], level)
        nwords = fr.pack_bits(new) if fused else None
        return new, queue_bytes, nwords, False, hits

    bottom_up_level = _bottom_up_level_fn(p, shard, s, mesh, axis, in_rows,
                                          bottom_up_wire, bottom_up_bytes,
                                          fused)
    return _level_runner(part, s, opts.mode, e_total, opts, dense_level,
                         queue_level, bottom_up_level, frontier_stats, fused,
                         _valid_words(part, dev))


def make_level_loop_2d(part2: Partition2D, s: int, e_total: int,
                       mesh: LocalMesh, row_axis, col_axis, opts: BFSOptions,
                       expand_strategy: ex.ExchangeStrategy,
                       fold_strategy: ex.ExchangeStrategy,
                       expand_sparse_strategy: ex.ExchangeStrategy,
                       fold_sparse_strategy: ex.ExchangeStrategy, edge_rows,
                       out_edges=None, in_rows=None,
                       bottom_up_wire: str = "bytes", sieve: bool = False,
                       fused: bool = False) -> Callable:
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
    — the ``(p, e_cap)`` ``src_rowlocal`` and ``dst_fold`` blocks — feed
    queue levels and the statistics; ``in_rows`` the bottom-up level.
    """
    r, c, b, p = part2.r, part2.c, part2.shard_size, part2.p
    n, fold_len, cap = part2.n, part2.fold_size, opts.queue_cap
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
    me_row = mesh.axis_index(row_axis)                          # (p,)
    me_col = mesh.axis_index(col_axis)
    frontier_stats = None
    if out_edges is not None:
        src_rowlocal, dst_fold = out_edges
        out_valid = dst_fold >= 0
        src_idx = torch.where(out_valid, src_rowlocal.long(), 0)
        # out-edges of each owned vertex into each grid column, from the
        # cell blocks (cell (i, j)'s sources are row block i's): a cell's
        # active edges are its row's frontier weighted by its column's
        cell = torch.arange(p, device=dev)[:, None]
        src_col = (src_idx + (cell // c) * c * b) * c + cell % c
        out_deg_col = torch.zeros(p * b * c, dtype=torch.int64,
                                  device=dev).index_add_(
            0, src_col[out_valid], torch.ones_like(src_col[out_valid])
        ).view(p, b, c)
        rr_base = torch.arange(r, device=dev, dtype=torch.int32)[:, None] * b

        def frontier_stats(frontier):
            """One host read: the frontier's pairs over every column and
            each cell's active edges from column 0's frontier."""
            per_chunk = (frontier[..., 0, None].long() * out_deg_col).sum(1)
            cells = per_chunk.view(r, c, c).sum(1).view(-1)     # (i, j)
            stats = torch.cat([frontier.sum(dtype=torch.int64).view(1),
                               cells]).tolist()
            return stats[0], sum(stats[1:]), max(1, max(stats[1:]))

    def expand_row_bytes(frow):                 # (p, c*b, S) -> (p*r*b, S)
        return fr.expand_dense_edges(frow.reshape(p * c * b, s), *edge_rows,
                                     p * fold_len)

    def dense_level(frontier, fwords, dist, level):
        if packed_expand:
            # fused plans gather the carried generation and read source
            # bits straight from the words (expand_dense_2d_packed: a word
            # gather and scatter-max over the edge rows); unfused ones
            # pack here and unpack the c gathered segments
            payload = fwords if fwords is not None else fr.pack_bits(frontier)
            fw = expand_strategy.impl(payload, mesh, col_axis)  # (p, c*W, S)
            if fused:
                cand = fr.expand_bottom_up_edges(fw, edge_rows, p * fold_len)
            else:
                cand = expand_row_bytes(fr.unpack_bits(fw, b, n_blocks=c))
        else:
            cand = expand_row_bytes(expand_strategy.impl(frontier, mesh,
                                                         col_axis))
        cand = cand.view(p, fold_len, s)
        if fold_strategy.wire == "packed":
            cw = fold_strategy.impl(fr.pack_bits(cand, n_blocks=r), mesh,
                                    row_axis)                   # (p, W, S)
            if fused:
                _, new, nwords = a1.fold_update(cw, dist, level, inplace=True)
                return new, dense_bytes, nwords
            own = fr.unpack_bits(cw, b)
        else:
            own = fold_strategy.impl(cand, mesh, row_axis)      # (p, b, S)
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
        ids, _, overflow = fr.pack_frontier_ids(frontier, cap)  # (p, cap)
        if use_comp_expand:
            pay, enc_ovf = fr.encode_delta_varint(ids, g_byte_cap, b)
            overflow = overflow | enc_ovf
            all_pay = expand_sparse_strategy.impl(pay, mesh, col_axis)
            all_ids = fr.decode_delta_varint(
                all_pay.view(p, c, g_byte_cap), cap, b).view(p, c * cap)
        else:
            all_ids = expand_sparse_strategy.impl(ids, mesh, col_axis)
        frow = fr.unpack_row_frontier(all_ids, c, b)            # (p, c*b, 1)
        full = (frow[..., 0].gather(1, src_idx) > 0) & out_valid
        # width bounds each cell's active edges from the true frontier; a
        # truncated compressed frontier can decode to more, but only where
        # its overflow escalates the level
        dst, active, counts = _pack_active(full, dst_fold, width)
        over = (counts > width).any()
        hits = torch.zeros((), dtype=torch.int64, device=dev)
        if sieve:
            drop = sieve_drop(dst, active, dist)
            hits = drop.sum()
            active = active & ~drop
        buckets, local_mask, _, bucket_ovf = fr.build_queue_buckets_2d(
            dst, active, part2, me_row, cap, local_update=opts.local_update,
            dedupe=opts.dedupe)
        if use_comp_fold:
            rel = torch.where(buckets >= 0, buckets - rr_base, -1)
            fpay, fenc_ovf = fr.encode_delta_varint(rel, g_byte_cap, b)
            bucket_ovf = bucket_ovf | fenc_ovf.any(-1)
        # Exactness: if any cell's frontier pack, bucket or compressed
        # stream overflowed, the whole level runs densely instead
        ovf, hits, over = torch.stack([(overflow | bucket_ovf).any().long(),
                                       hits, over.long()]).tolist()
        if over:
            if not ovf:
                raise RuntimeError("a queue level's active edges exceed the "
                                   "width its statistics bound")
            if sieve:     # the hits of every active edge, as JAX counts
                hits = int(sieve_drop(dst_fold, full, dist).sum())
        if ovf:
            new, bb, nwords = dense_level(frontier, fwords, dist, level)
            # the sparse expand (and sieve gather) above already ran
            return new, escalated_bytes, nwords, True, hits
        if use_comp_fold:
            recvp = fold_sparse_strategy.impl(fpay, mesh, row_axis)
            rec = fr.decode_delta_varint(recvp, cap, b)         # (p, r, cap)
            rec = torch.where(rec >= 0, rec + me_row[:, None, None] * b, -1)
        else:
            rec = fold_sparse_strategy.impl(buckets, mesh, row_axis)
        own = torch.maximum(fr.apply_queue(rec, me_row, b), local_mask)
        new = _owned_update(dist, own[..., None], level)
        nwords = fr.pack_bits(new) if fused else None
        return new, sparse_bytes, nwords, False, hits

    bottom_up_level = _bottom_up_level_fn(p, b, s, mesh, grid_axes, in_rows,
                                          bottom_up_wire, bottom_up_bytes,
                                          fused)
    return _level_runner(part2, s, opts.mode, e_total, opts, dense_level,
                         queue_level, bottom_up_level, frontier_stats, fused,
                         _valid_words(part2, dev))
