"""Dense frontier primitives and the packed-bitset wire format (paper
fig. 2) — the port of ``repro.core.frontier``'s dense part.

The frontier is a dense ``(shard, S)`` uint8 bitmap; expansion scatters
into a full-length ``(n, S)`` candidate mask, which the owner exchange
merges.  ``pack_bits``/``unpack_bits`` are the packed wire format of the
dense phases: 32 mask bytes collapse into one 32-bit word (LSB-first),
each owner's segment packed into its own ``ceil(m/32)`` words so block
boundaries stay word-aligned and a block's pad bits are zero.

Word convention: torch has no ``<<``, ``>>`` or ``max`` on uint32, so the
port carries every packed word as **int32 holding the uint32 bit
pattern**.  Bit 31 set reads as a negative int32; ``>>`` sign-extends,
which every bit test below undoes with ``& 1``.  Compare with the JAX
package through ``.numpy().view(np.uint32)``.

Every function takes optional leading batch dimensions (the stacked
shards of a ``LocalMesh``) in front of the shapes its docstring names.
The sparse-queue, bottom-up and 2-D primitives wait for later slices;
the byte-size helpers the exchange byte models need are here already.
"""

from __future__ import annotations

import math

import torch

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
# Byte sizes of the compressed wire and the visited sieve (host-side; the
# exchange byte models and plan description price them for every plan)
# ---------------------------------------------------------------------------

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


SIEVE_MAX_BITS = 1024     # summary bits per shard (<= 32 words = 128 B)


def sieve_layout(shard: int):
    """``(bits, bucket, words)`` of one shard's visited summary."""
    bits = min(SIEVE_MAX_BITS, max(1, shard))
    bucket = -(-shard // bits)
    bits = -(-shard // bucket)
    return bits, bucket, packed_words(bits)
