"""Frontier representations and the send-buffer builder (paper fig. 2) —
the port of ``repro.core.frontier``.

Two frontier representations:

  * dense bitmap — a ``(shard, S)`` uint8 mask; top-down expansion
    scatters into a full-length ``(n, S)`` candidate mask, which the owner
    exchange merges; bottom-up expansion reads the replicated frontier
    through each shard's in-edges.
  * sparse queue — the paper's per-destination buffers (``SendBuf_j``): a
    ``(p, cap)`` block of candidate global ids bucketed by owner, with the
    §5.1 local update (candidates a shard owns skip the wire), optional
    dedupe, and an overflow flag on which the caller escalates the level
    to the dense representation.

``pack_bits``/``unpack_bits`` are the packed wire format of the dense
phases: 32 mask bytes collapse into one 32-bit word (LSB-first), each
owner's segment packed into its own ``ceil(m/32)`` words so block
boundaries stay word-aligned and a block's pad bits are zero.
``encode_delta_varint``/``decode_delta_varint`` are the compressed wire
of the sparse phase (sorted ids as delta varints, or the id range's
bitset when that is shorter), and ``sieve_summary``/``sieve_lookup`` the
replicated coarse visited summary that drops candidates before the wire.

The 2-D edge partition reuses both representations per phase:
``expand_dense_2d`` (and ``expand_dense_2d_packed``, straight from the
gathered words) scatters a cell's edges into the transposed fold layout;
``pack_frontier_ids``/``unpack_row_frontier`` make the expand phase
sparse, and ``build_queue_buckets_2d`` buckets fold-layout candidates by
the row rank of their owner.

Word convention: torch has no ``<<``, ``>>`` or ``max`` on uint32, so the
port carries every packed word as **int32 holding the uint32 bit
pattern**.  Bit 31 set reads as a negative int32; ``>>`` sign-extends,
which every bit test below undoes with ``& 1``.  Compare with the JAX
package through ``.numpy().view(np.uint32)``.  The codec's header and
varint arithmetic runs in int64, masked to 32 bits where JAX's uint32
would wrap.

Every function takes optional leading batch dimensions (the stacked
shards of a ``LocalMesh``) in front of the shapes its docstring names.
JAX sorts stably, so every sort here passes ``stable=True`` where the
order of equal keys reaches an output; a JAX gather clamps an
out-of-range index where torch raises (or wraps a ``-1``), so indices
that could leave their range are masked or clamped first.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.partition import Partition1D

INF = 2 ** 30  # unreached sentinel (shared with bfs/engine/ref)


def init_dist_frontier(sources: torch.Tensor, n: int, n_logical: int,
                       out=None):
    """Device-side source injection: scatter an ``(S,)`` id vector into
    ``(n, S)`` int32 distance / uint8 frontier arrays.

    Slots with ``sources[j] < 0`` (or >= n_logical) are *empty*: their
    column stays all-INF / all-zero.  ``out=(dist, frontier)`` reuses
    preallocated buffers (overwritten in place) instead of allocating.
    """
    s = sources.shape[0]
    dev = sources.device
    if out is None:
        dist = torch.empty((n, s), dtype=torch.int32, device=dev)
        frontier = torch.empty((n, s), dtype=torch.uint8, device=dev)
    else:
        dist, frontier = out
    dist.fill_(INF)
    frontier.zero_()
    src = sources.to(torch.int64)
    ok = (src >= 0) & (src < n_logical)
    idx = src.clamp(0, n - 1)
    cols = torch.arange(s, device=dev)
    # each column's (row, col) pair is distinct, so plain writes suffice
    dist[idx, cols] = torch.where(ok, 0, INF).to(torch.int32)
    frontier[idx, cols] = ok.to(torch.uint8)
    return dist, frontier


def dense_edge_index(src_local: torch.Tensor, dst_global: torch.Tensor,
                     shard: int, n: int):
    """Flat gather/scatter rows of the *valid* edges of ``(g, E)`` stacked
    edge blocks: sources index the ``(g*shard, S)`` stacked frontier,
    targets the ``(g*n, S)`` stacked candidate masks.  Padding edges
    (``dst == -1``) are dropped here, once, instead of being routed to a
    dump row every level."""
    g = src_local.shape[0]
    base = torch.arange(g, device=src_local.device, dtype=torch.int64)[:, None]
    valid = dst_global >= 0
    src_idx = (src_local.to(torch.int64) + base * shard)[valid]
    dst_idx = (dst_global.to(torch.int64) + base * n)[valid]
    return src_idx, dst_idx


def expand_dense_edges(frontier_rows: torch.Tensor, src_idx: torch.Tensor,
                       dst_idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Scatter-max expansion over precomputed edge rows: ``(rows, S)``
    uint8 frontier -> ``(n_rows, S)`` uint8 candidates.

    The merge is a max, never a sum: a uint8 sum would wrap to 0 at 256
    in-edges from the frontier, and rmat hubs have thousands.
    """
    fvals = frontier_rows[src_idx]                              # (E, S)
    cand = torch.zeros((n_rows, frontier_rows.shape[1]), dtype=torch.uint8,
                       device=frontier_rows.device)
    return cand.scatter_reduce_(0, dst_idx[:, None].expand_as(fvals), fvals,
                                "amax")


def expand_dense(frontier: torch.Tensor, src_local: torch.Tensor,
                 dst_global: torch.Tensor, n: int) -> torch.Tensor:
    """Top-down edge expansion into a full-length candidate mask.

    frontier: (shard, S) uint8.  src_local/dst_global: (E,) int32 padded
    COO (dst -1 = padding).  Returns (n, S) uint8 candidates.
    """
    lead = frontier.shape[:-2]
    shard, s = frontier.shape[-2:]
    g = math.prod(lead)
    e = src_local.shape[-1]
    src_idx, dst_idx = dense_edge_index(src_local.reshape(g, e),
                                        dst_global.reshape(g, e), shard, n)
    cand = expand_dense_edges(frontier.reshape(g * shard, s), src_idx,
                              dst_idx, g * n)
    return cand.reshape(*lead, n, s)


def expand_dense_2d(frontier_row: torch.Tensor, src_rowlocal: torch.Tensor,
                    dst_fold: torch.Tensor, fold_len: int) -> torch.Tensor:
    """2-D edge expansion into the *transposed* fold-phase layout.

    frontier_row: (c*b, S) uint8 — the grid row's frontier segment (the
    expand-phase gather).  src_rowlocal/dst_fold: (E,) int32 padded COO of
    one cell; ``dst_fold`` indexes candidates as ``row_rank(owner(dst)) *
    b + local_id(dst)`` (-1 = padding).  Returns (fold_len, S) uint8 with
    ``fold_len = r*b``: the 1-D expansion with the row block as the shard
    and the fold layout as the id space.
    """
    return expand_dense(frontier_row, src_rowlocal, dst_fold, fold_len)


def _word_rows(src: torch.Tensor, m: int, words_per_block: int):
    """The word and the int32 bit of each id of ``src`` in a blocked
    ``pack_bits`` layout of ``m``-row blocks."""
    blk = torch.div(src, m, rounding_mode="floor")
    loc = src - blk * m
    return blk * words_per_block + loc // 32, (loc % 32).to(torch.int32)


def dense_2d_packed_edge_index(src_rowlocal: torch.Tensor,
                               dst_fold: torch.Tensor, m: int, fold_len: int):
    """Gather/scatter rows of the *valid* edges of ``(g, E)`` stacked cell
    blocks for ``expand_dense_2d_packed``: ``(blk, col, bit, dst)`` as
    ``bottom_up_edge_index`` returns them — each edge's cell, its
    source's word in the cell's gathered row words (``m`` vertices a
    block; a valid source lies in the row block, so no clamp) and bit
    there, and its target's row in the ``(g * fold_len, S)`` stacked
    candidates.  Padding edges (``dst_fold == -1``, source 0) are dropped
    here, once."""
    g = src_rowlocal.shape[0]
    base = torch.arange(g, device=src_rowlocal.device,
                        dtype=torch.int64)[:, None]
    valid = dst_fold >= 0
    blk = base.expand_as(valid)[valid]
    col, bit = _word_rows(src_rowlocal.to(torch.int64)[valid], m,
                          packed_words(m))
    dst = (dst_fold.to(torch.int64) + base * fold_len)[valid]
    return blk, col, bit, dst


def expand_dense_2d_packed(frontier_words: torch.Tensor,
                           src_rowlocal: torch.Tensor,
                           dst_fold: torch.Tensor, fold_len: int,
                           m: int) -> torch.Tensor:
    """2-D top-down expansion straight from the *packed* row frontier.

    ``frontier_words`` is the expand-phase gather kept packed: ``(c * W,
    S)`` words, block ``k`` = row peer ``k``'s ``pack_bits`` output over
    its ``m``-vertex chunk.  Each edge gathers one word and extracts its
    source's bit, so the ``(c*b, S)`` row byte mask is never made.  Equal
    to ``expand_dense_2d(unpack_bits(frontier_words, m, c), ...)``.
    """
    lead = frontier_words.shape[:-2]
    g = math.prod(lead)
    total_w, s = frontier_words.shape[-2:]
    e = src_rowlocal.shape[-1]
    rows = dense_2d_packed_edge_index(src_rowlocal.reshape(g, e),
                                      dst_fold.reshape(g, e), m, fold_len)
    cand = expand_bottom_up_edges(frontier_words.reshape(g, total_w, s),
                                  rows, g * fold_len)
    return cand.reshape(*lead, fold_len, s)


def bottom_up_edge_index(in_src_global: torch.Tensor,
                         in_dst_local: torch.Tensor, shard: int, n_cols: int,
                         words_per_block: Optional[int] = None):
    """Gather/scatter rows of the *live* in-edges of ``(g, E)`` stacked
    in-edge blocks, for the bottom-up expansion.

    An in-edge is live only when *both* endpoints are in range: a padded
    slot whose destination is ``-1`` but whose source holds a valid id
    must not scatter into the shard's last row (the JAX contract; a torch
    ``-1`` index wraps just as ``.at[-1]`` does).  Returns ``(blk, col,
    bit, dst)``: each live edge's block, its column in the gathered
    frontier (the source's row of the ``(n, S)`` byte frontier, or with
    ``words_per_block`` the source's word in the ``(p*W, S)`` packed
    frontier, ``bit`` its int32 bit there, else ``None``), clamped below
    ``n_cols`` as a JAX gather clamps, and its target's row in the
    ``(g*shard, S)`` stacked candidates.
    """
    g = in_src_global.shape[0]
    base = torch.arange(g, device=in_src_global.device,
                        dtype=torch.int64)[:, None]
    valid = ((in_src_global >= 0)
             & (in_dst_local >= 0) & (in_dst_local < shard))
    blk = base.expand_as(valid)[valid]
    src = in_src_global.to(torch.int64)[valid]
    dst = (in_dst_local.to(torch.int64) + base * shard)[valid]
    bit = None
    if words_per_block is not None:
        src, bit = _word_rows(src, shard, words_per_block)
    return blk, src.clamp_(max=n_cols - 1), bit, dst


def expand_bottom_up_edges(fglobal: torch.Tensor, rows,
                           n_rows: int) -> torch.Tensor:
    """Expansion over precomputed ``bottom_up_edge_index`` rows (or the
    ``dense_2d_packed_edge_index`` rows of the 2-D packed expand):
    ``(g, n_cols, S)`` gathered frontier (uint8 bytes, or int32 words when
    the rows carry bits; a stride-0 view of one replicated array is fine)
    -> ``(n_rows, S)`` uint8 candidates, merged by scatter-max."""
    blk, col, bit, dst = rows
    vals = fglobal[blk, col]                                    # (E, S)
    if bit is not None:
        # read each source's bit straight out of its word: the (n, S)
        # byte mask is never materialized
        vals >>= bit[:, None]
        vals = vals.bitwise_and_(1).to(torch.uint8)
    cand = torch.zeros((n_rows, fglobal.shape[-1]), dtype=torch.uint8,
                       device=fglobal.device)
    return cand.scatter_reduce_(0, dst[:, None].expand_as(vals), vals,
                                "amax")


def expand_bottom_up(frontier_global: torch.Tensor,
                     in_src_global: torch.Tensor, in_dst_local: torch.Tensor,
                     shard: int) -> torch.Tensor:
    """Bottom-up: each local vertex checks whether any in-neighbour is in
    the (replicated) frontier.  frontier_global: (n, S) uint8;
    in_src_global/in_dst_local: (E,) int32 padded in-edges.  Returns
    (shard, S) uint8 candidates."""
    lead = in_src_global.shape[:-1]
    g = math.prod(lead)
    n, s = frontier_global.shape[-2:]
    rows = bottom_up_edge_index(in_src_global.reshape(g, -1),
                                in_dst_local.reshape(g, -1), shard, n)
    cand = expand_bottom_up_edges(frontier_global.reshape(g, n, s), rows,
                                  g * shard)
    return cand.reshape(*lead, shard, s)


def expand_bottom_up_packed(frontier_words: torch.Tensor,
                            in_src_global: torch.Tensor,
                            in_dst_local: torch.Tensor, shard: int,
                            words_per_block: int) -> torch.Tensor:
    """Bottom-up expansion straight from the *packed* replicated frontier:
    ``frontier_words`` is the allgather of every shard's packed frontier
    (``(p * W, S)`` words, block ``k`` = shard ``k``'s ``pack_bits``
    output).  Same both-endpoints masking as ``expand_bottom_up``."""
    lead = in_src_global.shape[:-1]
    g = math.prod(lead)
    total_w, s = frontier_words.shape[-2:]
    rows = bottom_up_edge_index(in_src_global.reshape(g, -1),
                                in_dst_local.reshape(g, -1), shard, total_w,
                                words_per_block)
    cand = expand_bottom_up_edges(frontier_words.reshape(g, total_w, s),
                                  rows, g * shard)
    return cand.reshape(*lead, shard, s)


# ---------------------------------------------------------------------------
# Sparse queue: per-owner send buffers (paper fig. 2 lines 8-19)
# ---------------------------------------------------------------------------

def _rows(x: torch.Tensor) -> torch.Tensor:
    """``(..., E)`` -> ``(g, E)``: the leading dims as one batch dim."""
    return x.reshape(-1, x.shape[-1])


def _dedupe_owner(ids: torch.Tensor, active: torch.Tensor,
                  owner: torch.Tensor, sentinel: int,
                  n_owners: int) -> torch.Tensor:
    """Mask ``owner`` to ``n_owners`` for every duplicate active id: sort
    by target (stably), keep each id's first occurrence.  ``sentinel``
    must be the *padded* id-space size, strictly above every storable id
    (``padded_size + 1`` would overflow int32 at ``INT32_MAX``)."""
    tgt = torch.where(active, ids.to(torch.int64), sentinel)
    sorted_tgt, order = torch.sort(_rows(tgt), dim=-1, stable=True)
    first = torch.ones_like(sorted_tgt, dtype=torch.bool)
    first[:, 1:] = sorted_tgt[:, 1:] != sorted_tgt[:, :-1]
    keep = torch.zeros_like(first).scatter_(-1, order, first)
    return torch.where(keep.reshape(ids.shape), owner, n_owners)


def _pack_buckets(ids: torch.Tensor, owner: torch.Tensor, n_owners: int,
                  cap: int):
    """Stable bucket packing: sort ids by owner, rank within bucket.

    ``owner[k] == n_owners`` marks id ``k`` unsendable (inactive, deduped
    or locally applied).  Returns ((n_owners, cap) int32 buckets -1
    padded, () int32 sent count, () bool overflow).
    """
    lead = ids.shape[:-1]
    owner_s, sort_idx = torch.sort(_rows(owner.to(torch.int64)), dim=-1,
                                   stable=True)
    ids_s = _rows(ids).gather(-1, sort_idx).to(torch.int32)
    g, e = owner_s.shape
    dev = ids.device
    bounds = torch.arange(n_owners + 1, device=dev).expand(g, -1).contiguous()
    starts = torch.searchsorted(owner_s, bounds)
    rank = (torch.arange(e, device=dev)
            - starts.gather(-1, owner_s.clamp(0, n_owners)))
    sendable = owner_s < n_owners
    in_cap = sendable & (rank < cap)
    slot = torch.where(in_cap, owner_s * cap + rank, n_owners * cap)
    # in-cap slots are distinct; every other id lands in the dump slot
    buf = torch.full((g, n_owners * cap + 1), -1, dtype=torch.int32,
                     device=dev).scatter_(-1, slot,
                                          torch.where(in_cap, ids_s, -1))
    buckets = buf[:, : n_owners * cap].reshape(*lead, n_owners, cap)
    n_sent = in_cap.sum(-1, dtype=torch.int32).reshape(lead)
    overflow = (sendable & (rank >= cap)).any(-1).reshape(lead)
    return buckets, n_sent, overflow


def _build_buckets(ids: torch.Tensor, active: torch.Tensor, n_owners: int,
                   shard: int, me, cap: int, local_update: bool,
                   dedupe: bool):
    """Owner buckets of the active ``ids`` (owner ``id // shard``), with
    the §5.1 local update for owner ``me`` and the dedupe sentinel
    ``n_owners * shard``, the padded id-space size."""
    lead = ids.shape[:-1]
    dev = ids.device
    me = torch.as_tensor(me, device=dev).to(torch.int64).reshape(*lead, 1)
    dst = ids.to(torch.int64)
    owner = torch.where(active, torch.div(dst, shard, rounding_mode="floor"),
                        n_owners)
    if dedupe:
        owner = _dedupe_owner(dst, active, owner, n_owners * shard, n_owners)

    local_mask = torch.zeros((*lead, shard), dtype=torch.uint8, device=dev)
    if local_update:
        mine = owner == me
        lid = torch.where(mine, dst - me * shard, shard)
        local_mask = torch.zeros((math.prod(lead), shard + 1),
                                 dtype=torch.uint8, device=dev).scatter_reduce_(
            -1, _rows(lid), _rows(mine).to(torch.uint8), "amax")
        local_mask = local_mask[:, :shard].reshape(*lead, shard)
        owner = torch.where(mine, n_owners, owner)

    buckets, n_sent, overflow = _pack_buckets(ids, owner, n_owners, cap)
    return buckets, local_mask, n_sent, overflow


def build_queue_buckets(dst_global: torch.Tensor, active: torch.Tensor,
                        part: Partition1D, me, cap: int,
                        local_update: bool = True, dedupe: bool = True):
    """Pack active edge targets into per-owner send buffers.

    dst_global: (E,) int32 targets; active: (E,) bool (source in frontier
    and edge valid); ``me``: this shard's index (one per stacked shard).
    Returns:
      buckets:   (p, cap) int32 global ids, -1 padded — ``SendBuf_j``.
      local_mask:(shard,) uint8 — candidates applied locally (opt 5.1-1);
                 all-zero when ``local_update=False`` (they go in buckets).
      n_sent:    () int32 — total ids placed in send buffers.
      overflow:  () bool — some bucket exceeded cap (the caller escalates
                 to the dense representation).
    """
    return _build_buckets(dst_global, active, part.p, part.shard_size, me,
                          cap, local_update, dedupe)


def build_queue_buckets_2d(dst_fold: torch.Tensor, active: torch.Tensor,
                           part2, me_row, cap: int,
                           local_update: bool = True, dedupe: bool = True):
    """2-D analog of ``build_queue_buckets`` in the fold layout.

    Buckets active candidate targets by the *row rank* of their owner
    (``dst_fold // b``): bucket ``rr`` travels down the cell's grid column
    to the cell at row rank ``rr``, which owns the fold slice ``[rr*b,
    (rr+1)*b)``.  The local update applies with the cell's own row rank
    ``me_row``; the dedupe sentinel is the padded fold size ``r*b``.
    Returns (buckets (r, cap) int32 fold ids -1 padded, local_mask (b,)
    uint8, n_sent () int32, overflow () bool).
    """
    return _build_buckets(dst_fold, active, part2.r, part2.shard_size,
                          me_row, cap, local_update, dedupe)


def pack_frontier_ids(frontier: torch.Tensor, cap: int):
    """Pack the active local frontier (single-source column) into a
    fixed-capacity id buffer for the sparse expand phase.

    frontier: (shard, 1) uint8.  Returns (ids (cap,) int32 ascending local
    ids, -1 padded; count () int32; overflow () bool — more active
    vertices than ``cap``, on which the caller escalates the level).  The
    ids are JAX's sorted ones: each active vertex goes to its rank among
    the active ones (one scan over the flattened mask).
    """
    lead = frontier.shape[:-2]
    shard = frontier.shape[-2]
    g = math.prod(lead)
    act = (frontier[..., 0] > 0).reshape(g, shard)
    rank = act.reshape(-1).cumsum(0).view(g, shard)
    before = torch.cat([rank.new_zeros(1), rank[:-1, -1]])
    pos = rank - before[:, None] - 1
    slot = torch.where(act & (pos < cap), pos, cap)
    lid = torch.arange(shard, device=frontier.device,
                       dtype=torch.int32).expand(g, shard)
    ids = torch.full((g, cap + 1), -1, dtype=torch.int32,
                     device=frontier.device).scatter_(1, slot, lid)[:, :cap]
    count = act.sum(-1, dtype=torch.int32).reshape(lead)
    return ids.reshape(*lead, cap), count, count > cap


def unpack_row_frontier(all_ids: torch.Tensor, c: int,
                        shard: int) -> torch.Tensor:
    """Rebuild a grid row's frontier bitmap from ``c`` gathered id buffers.

    all_ids: (c*cap,) int32 — the row gather of every row peer's
    ``pack_frontier_ids`` buffer, segment ``j`` holding local ids of the
    chunk at grid column ``j``.  Returns (c*shard, 1) uint8, the row-block
    layout ``expand_dense_2d`` reads.  Ids outside ``[0, shard)`` drop.
    """
    lead = all_ids.shape[:-1]
    cap = all_ids.shape[-1] // c
    g = math.prod(lead)
    ids = all_ids.reshape(g, c, cap).to(torch.int64)
    ok = (ids >= 0) & (ids < shard)
    seg = torch.arange(c, device=all_ids.device)[:, None] * shard
    pos = torch.where(ok, ids + seg, c * shard).reshape(g, c * cap)
    frow = torch.zeros((g, c * shard + 1), dtype=torch.uint8,
                       device=all_ids.device).scatter_(
        1, pos, ok.reshape(g, c * cap).to(torch.uint8))
    return frow[:, : c * shard].reshape(*lead, c * shard, 1)


def apply_queue(recv: torch.Tensor, me, shard: int) -> torch.Tensor:
    """Scatter received global ids, ``(p, cap)``, into this shard's
    ``(shard,)`` uint8 candidate bitmap; pads and foreign ids drop."""
    lead = recv.shape[:-2]
    me = torch.as_tensor(me, device=recv.device).to(torch.int64).reshape(
        *lead, 1)
    flat = recv.reshape(*lead, -1).to(torch.int64)
    lid = flat - me * shard
    valid = (flat >= 0) & (lid >= 0) & (lid < shard)
    lid = torch.where(valid, lid, shard)
    mask = torch.zeros((math.prod(lead), shard + 1), dtype=torch.uint8,
                       device=recv.device).scatter_reduce_(
        -1, _rows(lid), _rows(valid).to(torch.uint8), "amax")
    return mask[:, :shard].reshape(*lead, shard)


def frontier_nonzero(frontier: torch.Tensor) -> torch.Tensor:
    """() bool: some vertex of the frontier is set (one reduction)."""
    return frontier.any()


# ---------------------------------------------------------------------------
# Packed-bitset wire format (dense phases)
# ---------------------------------------------------------------------------

def packed_words(n_bits: int) -> int:
    """Words needed to hold ``n_bits`` mask bits (ceil(n_bits / 32))."""
    return -(-n_bits // 32)


def pack_bits(mask: torch.Tensor, n_blocks: int = 1) -> torch.Tensor:
    """Pack a ``(n_blocks * m, S)`` 0/1 mask into ``(n_blocks * W, S)``
    int32 words (uint32 bit pattern), ``W = ceil(m / 32)``.

    Each length-``m`` block packs independently (bit ``i`` of word
    ``b*W + i//32`` is row ``b*m + i``); a block's trailing pad bits are
    zero.
    """
    *lead, total, s = mask.shape
    m = total // n_blocks
    if m * n_blocks != total:
        raise ValueError(f"{total} rows do not split into {n_blocks} blocks")
    w = packed_words(m)
    x = (mask > 0).reshape(*lead, n_blocks, m, s)
    if w * 32 != m:
        pad = torch.zeros((*lead, n_blocks, w * 32 - m, s), dtype=torch.bool,
                          device=mask.device)
        x = torch.cat([x, pad], dim=-2)
    x = x.reshape(*lead, n_blocks, w, 32, s).to(torch.int32)
    shifts = torch.arange(32, dtype=torch.int32, device=mask.device)
    # one shift and one sum: the 32 bits are distinct powers of two, so
    # the int32 sum carries nothing (bit 31 lands as the sign bit)
    words = (x << shifts[:, None]).sum(dim=-2, dtype=torch.int32)
    return words.reshape(*lead, n_blocks * w, s)


def unpack_bits(words: torch.Tensor, m: int, n_blocks: int = 1) -> torch.Tensor:
    """Inverse of ``pack_bits``: ``(n_blocks * W, S)`` words back to a
    ``(n_blocks * m, S)`` uint8 0/1 mask.  Each block's pad bits (rows
    ``m .. W*32``) are dropped, never surfaced as vertices.
    """
    *lead, total_w, s = words.shape
    w = total_w // n_blocks
    if w * n_blocks != total_w:
        raise ValueError(f"{total_w} words do not split into {n_blocks} blocks")
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.reshape(*lead, n_blocks, w, 1, s) >> shifts[:, None]) & 1
    bits = bits.reshape(*lead, n_blocks, w * 32, s)[..., :m, :]
    return bits.reshape(*lead, n_blocks * m, s).to(torch.uint8)


# ---------------------------------------------------------------------------
# Compressed sparse-id wire format (delta + varint, bitmap-adaptive)
# ---------------------------------------------------------------------------
# Sorted ids delta-encode to small gaps and gaps varint-encode to about one
# byte each ("Compression and Sieve", Lv et al.).  Buffers keep a fixed
# byte capacity (``compressed_capacity``), an overflow flag that escalates
# the level to dense, and a bitmap mode for when the whole id range packs
# smaller than the ids.

def varint_len(value: int) -> int:
    """Bytes a base-128 varint needs for ``value`` (>= 0)."""
    v = int(value)
    return (1 + (v >= 1 << 7) + (v >= 1 << 14) + (v >= 1 << 21)
            + (v >= 1 << 28))


def compressed_capacity(cap: int, id_range: int) -> int:
    """Static byte size of one compressed buffer for ``cap`` ids drawn
    from ``[0, id_range)``: a varint stream sized for deltas averaging
    twice the uniform spacing plus an 8-byte header and slack, or the
    range's packed bitset when that is smaller."""
    avg2 = max(1, (2 * max(1, id_range)) // max(1, cap))
    varint_cap = cap * varint_len(avg2) + 8
    bitmap_cap = 4 + 4 * packed_words(max(1, id_range))
    return min(varint_cap, bitmap_cap)


_U32 = 0xFFFFFFFF


def _le_bytes(word: torch.Tensor) -> torch.Tensor:
    """() 32-bit word (any integer dtype) -> (4,) uint8 little-endian."""
    shifts = 8 * torch.arange(4, device=word.device, dtype=torch.int64)
    return ((word.to(torch.int64)[..., None] >> shifts) & 0xFF).to(
        torch.uint8)


def encode_delta_varint(ids: torch.Tensor, byte_cap: int, id_range: int):
    """Encode a -1-padded id buffer into a fixed-size compressed payload.

    ids: (cap,) int32, valid entries in ``[0, id_range)``, -1 = padding,
    any order (they are sorted here).  Returns ``(buf (byte_cap,) uint8,
    overflow () bool)``.

    Layout: a 4-byte little-endian header word (bits 0-30 = id count,
    bit 31 = bitmap mode), then either the sorted ids' delta stream as
    LSB-first base-128 varints (high bit = continuation) or, in bitmap
    mode, the range's packed bitset words, little-endian.  Bitmap mode
    engages when it statically fits ``byte_cap`` and the varint stream
    runs longer; ``overflow`` is True only when the varints spill *and*
    no bitmap slot exists.
    """
    lead, cap = ids.shape[:-1], ids.shape[-1]
    dev = ids.device
    valid = (ids >= 0) & (ids < id_range)
    count = valid.sum(-1)                                       # int64
    key = torch.where(valid, ids.to(torch.int64), id_range)
    srt = torch.sort(key, dim=-1, stable=True).values
    k = torch.arange(cap, device=dev)
    live = k < count[..., None]
    prev = torch.where(k > 0, srt[..., (k - 1).clamp(min=0)], 0)
    delta = torch.where(live, srt - prev, 0)

    nlen = (1 + (delta >= 1 << 7).long() + (delta >= 1 << 14).long()
            + (delta >= 1 << 21).long() + (delta >= 1 << 28).long())
    nlen = torch.where(live, nlen, 0)
    off = torch.cumsum(nlen, -1) - nlen                         # exclusive
    total = 4 + nlen.sum(-1)
    varint_ovf = total > byte_cap

    # slot k's group j (j < nlen[k]) lands at byte 4 + off[k] + j; spilled
    # or dead bytes divert to the dump slot at index byte_cap
    j = torch.arange(5, device=dev)
    emit = j < nlen[..., None]                                  # (cap, 5)
    grp = (delta[..., None] >> (7 * j)) & 0x7F
    cont = j < (nlen - 1)[..., None]
    payload = torch.where(cont, grp | 0x80, grp)
    payload = torch.where(emit, payload, 0).to(torch.uint8)
    pos = 4 + off[..., None] + j
    pos = torch.where(emit & (pos < byte_cap), pos, byte_cap)
    g = math.prod(lead)
    buf = torch.zeros((g, byte_cap + 1), dtype=torch.uint8,
                      device=dev).scatter_reduce_(
        -1, pos.reshape(g, cap * 5), payload.reshape(g, cap * 5), "amax")
    buf = buf[:, :byte_cap].reshape(*lead, byte_cap)

    hdr = count
    w = packed_words(id_range)
    if 4 + 4 * w <= byte_cap:                # bitmap rescue statically fits
        mask = torch.zeros((g, id_range + 1), dtype=torch.uint8,
                           device=dev).scatter_reduce_(
            -1, _rows(key), _rows(valid).to(torch.uint8), "amax")
        words = pack_bits(mask[:, :id_range, None])[..., 0]     # (g, w)
        bbuf = torch.zeros((g, byte_cap), dtype=torch.uint8, device=dev)
        bbuf[:, 4:4 + 4 * w] = _le_bytes(words).reshape(g, 4 * w)
        use_bitmap = total > 4 + 4 * w
        buf = torch.where(use_bitmap[..., None],
                          bbuf.reshape(*lead, byte_cap), buf)
        hdr = hdr | (use_bitmap.long() << 31)
        overflow = torch.zeros_like(varint_ovf)  # bitmap always representable
    else:
        overflow = varint_ovf
    buf[..., :4] = _le_bytes(hdr)
    return buf, overflow


def decode_delta_varint(buf: torch.Tensor, cap: int, id_range: int):
    """Inverse of ``encode_delta_varint``: (byte_cap,) uint8 payload ->
    (cap,) int32 sorted ids, -1 padded at the tail.

    Trailing zero bytes would decode as phantom zero-delta groups; the
    header count masks everything past the real ids to -1.  The header's
    bit 31 (bitmap mode) is read as ``(hdr >> 31) & 1`` of the int64 word.
    """
    lead, byte_cap = buf.shape[:-1], buf.shape[-1]
    dev = buf.device
    shifts = 8 * torch.arange(4, device=dev, dtype=torch.int64)
    hdr = (buf[..., :4].to(torch.int64) << shifts).sum(-1)
    count = hdr & 0x7FFFFFFF
    use_bitmap = ((hdr >> 31) & 1) > 0
    data = buf[..., 4:].to(torch.int64)
    d = data.shape[-1]

    # group index per byte = exclusive count of terminators (high bit 0)
    # before it; within-group position from the previous terminator
    term = (data & 0x80) == 0
    g = torch.cumsum(term.long(), -1) - term.long()
    idx = torch.arange(d, device=dev)
    startm = torch.cummax(torch.where(term, idx + 1, 0), -1).values
    start = torch.cat([torch.zeros_like(startm[..., :1]),
                       startm[..., :-1]], -1)
    within = idx - start
    # a 32-bit lane: the fifth group's top bits fall off as in uint32
    contrib = torch.where(within <= 4,
                          ((data & 0x7F) << (7 * within.clamp(max=4))) & _U32,
                          0)
    rows = math.prod(lead)
    deltas = torch.zeros((rows, cap + 1), dtype=torch.int64,
                         device=dev).scatter_add_(
        -1, _rows(g.clamp(max=cap)), _rows(contrib))[:, :cap] & _U32
    # int32 running sum of the uint32 deltas, wrapping as JAX's does
    acc = torch.cumsum(deltas, -1).to(torch.int32).reshape(*lead, cap)
    k = torch.arange(cap, device=dev)
    ids_varint = torch.where(k < count[..., None], acc, -1).to(torch.int32)

    w = packed_words(id_range)
    if 4 + 4 * w <= byte_cap:                # bitmap mode statically possible
        wraw = data[..., : 4 * w].reshape(*lead, w, 4)
        words = (wraw << shifts).sum(-1).to(torch.int32)        # (..., w)
        mask = unpack_bits(words[..., None], id_range)[..., 0]
        lid = torch.where(mask > 0, torch.arange(id_range, device=dev),
                          id_range)
        if cap > id_range:
            lid = torch.cat([lid, lid.new_full((*lead, cap - id_range),
                                               id_range)], -1)
        packed = torch.sort(lid, dim=-1, stable=True).values[..., :cap]
        ids_bitmap = torch.where(packed < id_range, packed, -1).to(
            torch.int32)
        return torch.where(use_bitmap[..., None], ids_bitmap, ids_varint)
    return ids_varint


# ---------------------------------------------------------------------------
# Visited sieve: replicated coarse visited summary ("Compression and Sieve")
# ---------------------------------------------------------------------------

SIEVE_MAX_BITS = 1024     # summary bits per shard (<= 32 words = 128 B)


def sieve_layout(shard: int):
    """``(bits, bucket, words)`` of one shard's visited summary."""
    bits = min(SIEVE_MAX_BITS, max(1, shard))
    bucket = -(-shard // bits)
    bits = -(-shard // bucket)
    return bits, bucket, packed_words(bits)


def sieve_summary(dist_col: torch.Tensor, bits: int,
                  bucket: int) -> torch.Tensor:
    """(shard,) int32 distances -> (words,) int32 summary words; bit ``k``
    is set iff *every* vertex of bucket ``k`` is visited, so a candidate
    landing there is provably redundant and sieving never changes a
    distance.  Pad slots of a straddling final bucket count as visited
    (they are never candidates), keeping the bit exact."""
    *lead, shard = dist_col.shape
    visited = dist_col < INF
    if bits * bucket != shard:
        visited = torch.cat([visited, visited.new_ones(
            (*lead, bits * bucket - shard))], -1)
    full = visited.reshape(*lead, bits, bucket).all(-1)
    return pack_bits(full[..., None].to(torch.uint8))[..., 0]


def sieve_lookup(gwords: torch.Tensor, gids: torch.Tensor, shard: int,
                 bits: int, bucket: int, words: int) -> torch.Tensor:
    """Look candidate *global* ids up in the replicated summary.

    gwords: (n_shards * words,) summary words, block ``k`` = shard ``k``'s
    ``sieve_summary``; gids: (E,) int32 candidates (negatives pass through
    unhit).  Returns a bool mask, True where the candidate's whole bucket
    is already visited.  The word index is clamped as a JAX gather clamps
    it."""
    ok = gids >= 0
    gid = torch.where(ok, gids.to(torch.int64), 0)
    owner = torch.div(gid, shard, rounding_mode="floor")
    bit = torch.div(gid - owner * shard, bucket, rounding_mode="floor")
    widx = (owner * words + bit // 32).clamp_(max=gwords.shape[-1] - 1)
    word = gwords.gather(-1, widx)
    hit = ((word >> (bit % 32).to(word.dtype)) & 1) > 0
    return hit & ok
