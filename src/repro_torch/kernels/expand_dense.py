"""Edge-list expansion of the 1-D dense level, straight to the packed wire.

The default engine's top-down expansion pushes every active source's
frontier row along its out-edges into a full-length candidate mask per
stacked shard, and the packed dense wire ships that mask as
``pack_bits(cand, n_blocks=p)`` words.  This module does both at once over
a CSR of the out-edges by source, built once per engine:

* ``edge_csr`` — the index: each stacked shard's valid out-edges, sorted
  stably by local source, as ``(row_ptr, dst)``: int64 offsets over the
  ``local * shard`` stacked source rows and each edge's int32 global
  target.  Padding edges (``dst == -1``) are dropped.
* ``expand_dense`` — the dispatcher: on a CUDA tensor it launches the
  hand-written kernel (``csrc/bfs_kernels.cu`` ``expand_dense_kernel``,
  with its mask and pack passes) or raises; on a CPU tensor it runs
  ``expand_dense_plain``.
* ``expand_dense_plain`` — the same function in plain torch ops: the
  gather and scatter-max of ``frontier.expand_dense_edges`` over the CSR's
  rows, then ``pack_bits``.  The CPU tests hold it to the JAX expansion,
  and the card holds the kernel to it.

It replaces no TPU kernel: the JAX package leaves this expansion to XLA's
gather and scatter.  Words are int32 holding the uint32 bit pattern.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.frontier import expand_dense_edges, pack_bits, packed_words
from repro_torch.kernels import _build

#: edges a warp of the kernel takes at a time (the persistent grid walks
#: the edge array in chunks of this size, so hubs split over warps)
EDGE_CHUNK = 512
#: edges ``edge_csr`` moves and sorts at a time
EDGE_SLICE = 1 << 24


def edge_csr(src_local, dst_global, shard: int, device=None):
    """The out-edge CSR of ``(g, E)`` stacked edge blocks (``src_local``
    in ``[0, shard)``, ``dst_global`` -1 for padding): ``(row_ptr, dst)``,
    ``row_ptr`` ``(g * shard + 1,)`` int64 offsets of stacked source row
    ``j * shard + u`` (shard ``j``, local source ``u``) into ``dst``, the
    ``(E_valid,)`` int32 targets, shard by shard, each shard's edges
    sorted stably by source.

    The blocks may lie on the host (numpy arrays or tensors): they move to
    ``device`` (by default their own) ``EDGE_SLICE`` edges at a time, and
    each slice is sorted alone and placed behind the slices before it, so
    the build never holds more than a slice's temporaries beside the CSR.
    """
    dev = torch.device(device) if device is not None else (
        torch.as_tensor(src_local[:0]).device)

    def slices(j):
        e = len(src_local[j])
        for lo in range(0, e, EDGE_SLICE):
            d = torch.as_tensor(dst_global[j][lo:lo + EDGE_SLICE]).to(dev)
            valid = d >= 0
            yield (torch.as_tensor(src_local[j][lo:lo + EDGE_SLICE]).to(dev)
                   [valid].long() + j * shard), d[valid]

    g = len(src_local)
    counts = torch.zeros((g * shard + 1,), dtype=torch.int64, device=dev)
    for j in range(g):
        for src, _ in slices(j):
            counts.index_add_(0, src + 1, torch.ones_like(src))
    row_ptr = torch.cumsum(counts, 0)
    dst = torch.empty((int(row_ptr[-1]),), dtype=torch.int32, device=dev)
    fill = row_ptr[:-1].clone()               # each source's next slot
    for j in range(g):
        for src, d in slices(j):
            key, order = torch.sort(src, stable=True)
            # each edge's rank among its source's edges of this slice
            rank = (torch.arange(key.numel(), device=dev)
                    - torch.searchsorted(key, key))
            dst[fill[key] + rank] = d[order].to(torch.int32)
            fill.index_add_(0, key, torch.ones_like(key))
    return row_ptr, dst


def _check(frontier, row_ptr, dst, n, n_blocks, edges_read):
    if (frontier.dtype != torch.uint8 or row_ptr.dtype != torch.int64
            or dst.dtype != torch.int32):
        raise ValueError("expand_dense takes a uint8 frontier, int64 row_ptr "
                         f"and int32 targets (got {frontier.dtype}, "
                         f"{row_ptr.dtype}, {dst.dtype})")
    if frontier.dim() != 3:
        raise ValueError(f"frontier {tuple(frontier.shape)} is not "
                         "(shards, shard, S)")
    g, shard, s = frontier.shape
    if row_ptr.shape != (g * shard + 1,) or dst.dim() != 1:
        raise ValueError(f"row_ptr {tuple(row_ptr.shape)} and targets "
                         f"{tuple(dst.shape)} are not the CSR of {g} x "
                         f"{shard} source rows")
    if n_blocks < 1 or n % n_blocks or n < 1:
        raise ValueError(f"{n} candidate rows do not split into {n_blocks} "
                         "blocks")
    if edges_read is not None and (
            edges_read.dtype != torch.int64 or edges_read.shape != (1,)
            or edges_read.device != frontier.device):
        raise ValueError("edges_read is a (1,) int64 counter on the "
                         f"frontier's device (got {edges_read.dtype} "
                         f"{tuple(edges_read.shape)} on {edges_read.device})")


def expand_dense_plain(frontier: torch.Tensor, row_ptr: torch.Tensor,
                       dst: torch.Tensor, *, n: int, n_blocks: int,
                       edges_read: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Plain torch version of ``expand_dense``."""
    _check(frontier, row_ptr, dst, n, n_blocks, edges_read)
    g, shard, s = frontier.shape
    rows = g * shard
    src = torch.repeat_interleave(
        torch.arange(rows, device=frontier.device), row_ptr.diff())
    tgt = dst.long() + torch.div(src, shard, rounding_mode="floor") * n
    flat = frontier.reshape(rows, s)
    if edges_read is not None:
        edges_read += (flat > 0).any(1)[src].sum()
    cand = expand_dense_edges(flat, src, tgt, g * n)
    return pack_bits(cand.view(g, n, s), n_blocks)


def expand_dense(frontier: torch.Tensor, row_ptr: torch.Tensor,
                 dst: torch.Tensor, *, n: int, n_blocks: int,
                 edges_read: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed candidate words of a top-down dense level.

    Args:
      frontier: ``(g, shard, S)`` uint8, the stacked shards' frontier rows
        (nonzero = in the frontier).
      row_ptr, dst: ``edge_csr`` of the same shards' out-edges.
      n: candidate rows a shard (the padded vertex count), in
        ``n_blocks`` owner blocks of ``m = n / n_blocks`` rows.
      edges_read: a ``(1,)`` int64 counter on the frontier's device, or
        None.  Where given, the launch adds the out-edges of the sources
        in the frontier of some column: the edges it pushed.

    Returns ``(g, n_blocks * W, S)`` int32 words, ``W = ceil(m / 32)``:
    shard ``j``'s ``pack_bits(cand_j, n_blocks)``, where ``cand_j[v, s]``
    is set iff some edge ``u -> v`` of shard ``j`` has ``u`` in column
    ``s``'s frontier (the scatter-max of ``frontier.expand_dense_edges``).
    """
    if frontier.device.type == "cpu":
        return expand_dense_plain(frontier, row_ptr, dst, n=n,
                                  n_blocks=n_blocks, edges_read=edges_read)
    _check(frontier, row_ptr, dst, n, n_blocks, edges_read)
    dev = _build.require_cuda("expand_dense", frontier, row_ptr, dst)
    g, shard, s = frontier.shape
    m = n // n_blocks
    k64 = -(-s // 64)                   # 64-bit masks a source row
    words = torch.empty((g, n_blocks * packed_words(m), s), dtype=torch.int32,
                        device=dev)
    if not words.numel():
        return words
    fmask = torch.empty((g * shard, k64), dtype=torch.int64, device=dev)
    table = torch.empty((g * n, k64), dtype=torch.int64, device=dev)
    chunk_rows = torch.empty((-(-dst.shape[0] // EDGE_CHUNK),),
                             dtype=torch.int64, device=dev)
    _build.launch("bfs_expand_dense", dev, frontier.data_ptr(),
                  row_ptr.data_ptr(), dst.data_ptr(), fmask.data_ptr(),
                  table.data_ptr(), chunk_rows.data_ptr(), words.data_ptr(),
                  edges_read.data_ptr() if edges_read is not None else None,
                  g, shard, n, n_blocks, dst.shape[0], EDGE_CHUNK, s)
    expand_dense.launches += 1
    return words


expand_dense.launches = 0
