"""Partitioned, statically-shaped graph containers — the port of
``repro.graphs.formats``.

A ``ShardedGraph`` stores, for each of the ``p`` shards, a fixed-capacity
COO edge block padded with sentinel edges (``dst == -1``).  Out-edges are
partitioned by ``owner(src)`` (the paper's 1-D partitioning: the owner of a
vertex expands it) and, for the bottom-up pass of a later slice, in-edges
by ``owner(dst)``.

The host arrays are numpy and equal ``repro.graphs.shard_graph``'s (and
``shard_graph_2d``'s) output bitwise; ``from_jax_arrays`` (and
``from_jax_arrays_2d``) carries a JAX-built container across so both
engines traverse the identical graph, and ``to_device`` uploads the edge
blocks as torch tensors.  The blocked adjacency (``bsr_shards`` in f32, and
``bsr_bit_shards`` at one bit an entry, the ``use_kernel`` engine's) is
built straight on the target device: only the tile indices are computed
on the host, so a multi-GB tile array never exists in host memory.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import weakref

import numpy as np
import torch

from repro_torch.core.partition import Partition1D, Partition2D

_ALIGN = 128  # pad per-shard edge capacity to a lane-aligned multiple

# Guard only the creation of each graph's to_2d lock and of its
# DeviceBlockCache; the conversions and uploads themselves run under the
# per-graph locks, so engine compiles of unrelated graphs never wait on
# each other.
_TO2D_CREATE_LOCK = threading.Lock()
_DEVICE_BLOCKS_CREATE_LOCK = threading.Lock()


class DeviceBlockCache:
    """Per-graph dedup state for uploaded device tensors: a *weak*
    per-(mesh, axis, group) map plus the lock that guards its
    check-then-insert.  Engines hold the strong references
    (``core.engine._BlockGroup``), so every engine of one graph on one
    mesh shares one upload of each group, and when the last engine using
    a group is dropped its device memory frees.  A ``to_2d`` view shares
    its parent's instance."""

    __slots__ = ("lock", "map")

    def __init__(self):
        self.lock = threading.Lock()
        self.map = weakref.WeakValueDictionary()

    def __len__(self) -> int:
        return len(self.map)


def device_block_cache(graph) -> DeviceBlockCache:
    """Get-or-create ``graph._device_blocks`` (every creation path —
    engine compile or ``to_2d`` — funnels through here)."""
    with _DEVICE_BLOCKS_CREATE_LOCK:
        m = graph.__dict__.get("_device_blocks")
        if m is None:
            m = graph.__dict__["_device_blocks"] = DeviceBlockCache()
        return m


def _content_fingerprint(meta: tuple, arrays: tuple) -> tuple:
    """Stable content hash of a graph container: structural metadata plus
    a digest of the edge blocks."""
    h = hashlib.sha1(repr(meta).encode())
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return meta + (h.hexdigest(),)


def _cached_counts(graph, name: str, block: np.ndarray) -> np.ndarray:
    """(p,) count of the valid (non-negative) slots of each row of
    ``block``, cached on ``graph`` under ``name``."""
    got = graph.__dict__.get(name)
    if got is None:
        got = graph.__dict__[name] = (block >= 0).sum(1)
    return got


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _block_keys(src: np.ndarray, dst: np.ndarray, n: int, block: int):
    """Sorted unique ``row_block * nb + col_block`` tile keys of a COO edge
    set, and each edge's tile index into them."""
    nb = -(-n // block)
    key = (src // block) * nb + dst // block
    uniq, inv = np.unique(key, return_inverse=True)
    return uniq, inv, nb


@dataclasses.dataclass
class ShardedGraph:
    """1-D partitioned graph in padded per-shard COO blocks (numpy).

    Attributes:
      part: the vertex partition.
      src_local:  (p, e_cap) int32 — local id of edge source within shard.
      dst_global: (p, e_cap) int32 — global id of edge target; -1 = padding.
      in_src_global / in_dst_local: same for the in-edge (transposed)
        partitioning.
      n_edges: true (unpadded) directed edge count.
    """

    part: Partition1D
    src_local: np.ndarray
    dst_global: np.ndarray
    in_src_global: np.ndarray
    in_dst_local: np.ndarray
    n_edges: int

    @property
    def p(self) -> int:
        return self.part.p

    @property
    def e_cap(self) -> int:
        return self.src_local.shape[1]

    @property
    def in_e_cap(self) -> int:
        return self.in_src_global.shape[1]

    def flat(self):
        """Arrays reshaped to (p * cap,)."""
        return (
            self.src_local.reshape(-1),
            self.dst_global.reshape(-1),
            self.in_src_global.reshape(-1),
            self.in_dst_local.reshape(-1),
        )

    def to_device(self, device) -> dict:
        """The four (p, cap) int32 edge blocks as torch tensors on
        ``device`` — what a compiled engine keeps resident."""
        names = ("src_local", "dst_global", "in_src_global", "in_dst_local")
        return {k: torch.as_tensor(getattr(self, k)).to(device) for k in names}

    def degrees(self) -> np.ndarray:
        """In-degree per (padded) global vertex."""
        deg = np.zeros(self.part.n, dtype=np.int64)
        d = self.dst_global[self.dst_global >= 0]
        np.add.at(deg, d, 1)
        return deg

    def edge_list(self):
        """Reconstruct the global COO edge list from the out-edge blocks
        (shard-bucketed order, not the original insertion order)."""
        shard_base = (np.arange(self.p, dtype=np.int64)[:, None]
                      * self.part.shard_size)
        valid = self.dst_global >= 0
        src = (self.src_local.astype(np.int64) + shard_base)[valid]
        dst = self.dst_global[valid].astype(np.int64)
        return src, dst

    def fingerprint(self) -> tuple:
        """Content identity (cached; the blocks are immutable once built)."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            fp = _content_fingerprint(
                ("sharded_graph_1d", self.part.n_logical, self.p,
                 self.e_cap, self.n_edges),
                (self.src_local, self.dst_global))
            self.__dict__["_fingerprint"] = fp
        return fp

    def edge_counts(self) -> np.ndarray:
        """(p,) valid out-edges of each shard's block (cached)."""
        return _cached_counts(self, "_edge_counts", self.dst_global)

    def in_edge_counts(self) -> np.ndarray:
        """(p,) valid in-edges of each shard's in-edge block (cached)."""
        return _cached_counts(self, "_in_edge_counts", self.in_src_global)

    def bsr_shard_caps(self, block: int = 128):
        """``(kmax, block)`` of ``bsr_shards()`` without building tiles."""
        kmax, _ = self._bsr_index(block)[:2]
        return kmax, block

    def _bsr_index(self, block: int):
        """Host-side tile layout of ``bsr_shards`` (cached per block):
        ``(kmax, block_rows (p, K), block_cols (p, K), edge_tile (E, 4)
        [shard, tile, row-in-tile, col-in-tile], n_rows_pad, n_cols_pad)``.
        """
        cache = self.__dict__.setdefault("_bsr_index_cache", {})
        got = cache.get(block)
        if got is not None:
            return got
        part = self.part
        p, shard = self.p, part.shard_size
        per_shard, edges = [], []
        for j in range(p):
            valid = self.dst_global[j] >= 0
            src_l = self.src_local[j][valid].astype(np.int64)   # cols
            dst_g = self.dst_global[j][valid].astype(np.int64)  # rows
            uniq, inv, nb = _block_keys(dst_g, src_l, part.n, block)
            per_shard.append(((uniq // nb).astype(np.int32),
                              (uniq % nb).astype(np.int32)))
            edges.append(np.stack([np.full_like(inv, j), inv,
                                   dst_g % block, src_l % block], axis=1))
        # at least one (all-zero) tile so an edgeless shard still hands
        # the kernel a nonempty tile list
        kmax = max(1, max(br.shape[0] for br, _ in per_shard))
        br_out = np.zeros((p, kmax), np.int32)
        bc_out = np.zeros((p, kmax), np.int32)
        for j, (brr, bcc) in enumerate(per_shard):
            k = brr.shape[0]
            br_out[j, :k] = brr
            bc_out[j, :k] = bcc
            if k < kmax:           # pad tiles repeat the last block row
                br_out[j, k:] = brr[-1] if k else 0
        got = (kmax, br_out, bc_out, np.concatenate(edges, axis=0),
               _pad_to(part.n, block), _pad_to(shard, block))
        cache[block] = got
        return got

    def bsr_shards(self, block: int = 128, device="cpu"):
        """Per-shard blocked *transposed* adjacency for the ``bsr_spmm``
        frontier expansion, as torch tensors on ``device``.

        Shard ``j``'s matrix has rows = global candidate ids (padded to a
        block multiple of ``part.n``) and cols = local source ids (padded
        to a block multiple of ``shard_size``), so ``A_j @ f_local`` is the
        shard's dense expansion.  Tiles are sorted by block row; shards are
        padded to a common tile count with all-zero tiles that repeat the
        shard's last block row (never a smaller one), so every shard's
        tile list stays sorted.  Equal to ``repro.graphs.ShardedGraph.
        bsr_shards`` bitwise.

        Returns ``(blocks (p, K, B, B) f32, block_rows (p, K) i32,
        block_cols (p, K) i32, n_rows_pad, n_cols_pad)``.
        """
        kmax, br, bc, edge_tile, row_pad, col_pad = self._bsr_index(block)
        blocks = torch.zeros((self.p, kmax, block, block), dtype=torch.float32,
                             device=device)
        idx = torch.as_tensor(edge_tile).to(device)
        blocks[idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]] = 1.0
        return (blocks, torch.as_tensor(br).to(device),
                torch.as_tensor(bc).to(device), row_pad, col_pad)

    def bsr_bit_shards(self, device="cpu", shards=None):
        """``bsr_shards``' tiles at one bit an entry, for the engine's
        boolean expansion (``kernels.bsr_spmm.kernel.bsr_expand_bits``),
        built on ``device`` with no f32 tile ever made.  The block is 128.
        ``shards`` (a ``range`` of shard indices; default all ``p``)
        builds only those shards' tiles, as a rank of a ``DistMesh`` holds
        only its own; they keep every shard's common tile count.

        ``bits[j, k, c, q]`` holds column ``c`` of shard ``j``'s tile
        ``k``: bit ``b`` is row ``32 q + b`` (LSB-first, int32 carrying
        the uint32 pattern), so ``unpack_bit_tiles(bits)`` (in
        ``kernels.bsr_spmm.ref``) is ``bsr_shards()[0]`` bitwise.
        ``col_mask[j, k, w]`` bit ``b`` is set where column ``32 w + b``
        of the tile holds an edge: the kernel reads it to skip a tile no
        frontier column reaches.  Pad tiles, block rows and block columns
        are ``bsr_shards``' own.

        Duplicate edges set one bit: the edges are deduplicated, then
        distinct powers of two are added, which is their OR.

        Returns ``(bits (p, K, 128, 4) i32, col_mask (p, K, 4) i32,
        block_rows (p, K) i32, block_cols (p, K) i32, n_rows_pad,
        n_cols_pad)`` (``len(shards)`` in place of ``p``).
        """
        block = 128
        shards = range(self.p) if shards is None else shards
        kmax, br, bc, edge_tile, row_pad, col_pad = self._bsr_index(block)
        bits = torch.zeros((len(shards), kmax, block, block // 32),
                           dtype=torch.int32, device=device)
        col_mask = torch.zeros((len(shards), kmax, block // 32),
                               dtype=torch.int32, device=device)
        # edge_tile is grouped by shard; one shard at a time keeps the
        # flat indices below 2**31 words and the temporaries small
        bounds = np.searchsorted(edge_tile[:, 0], np.arange(self.p + 1))
        for j, shard in enumerate(shards):
            idx = torch.as_tensor(
                edge_tile[bounds[shard]:bounds[shard + 1], 1:]).to(
                device)                            # (E_j, 3) tile, row, col
            tile_col = idx[:, 0] * block + idx[:, 2]
            # word (tile, col, row // 32) of bits takes 1 << (row % 32)
            # once per distinct (tile, col, row); word (tile, col // 32) of
            # col_mask takes 1 << (col % 32) once per distinct (tile, col)
            for out, key in ((bits[j], tile_col * block + idx[:, 1]),
                             (col_mask[j], tile_col)):
                key = torch.unique(key)
                word = (key >> 7) * 4 + ((key & 127) >> 5)
                one = torch.ones_like(key, dtype=torch.int32)
                out.view(-1).index_add_(0, word, one << (key & 31).to(
                    torch.int32))                  # 1 << 31 is the sign bit
        held = slice(shards[0], shards[-1] + 1)
        return (bits, col_mask, torch.as_tensor(br[held]).to(device),
                torch.as_tensor(bc[held]).to(device), row_pad, col_pad)


def from_jax_arrays(graph) -> ShardedGraph:
    """Carry a ``repro.graphs.ShardedGraph`` across to the port.

    Reads the JAX container's numpy blocks (duck-typed: ``part.n_logical``,
    ``part.p`` and the four edge blocks), so the port never imports the
    JAX package and both engines traverse the identical graph.
    """
    return ShardedGraph(
        part=Partition1D(int(graph.part.n_logical), int(graph.part.p)),
        src_local=np.asarray(graph.src_local, np.int32),
        dst_global=np.asarray(graph.dst_global, np.int32),
        in_src_global=np.asarray(graph.in_src_global, np.int32),
        in_dst_local=np.asarray(graph.in_dst_local, np.int32),
        n_edges=int(graph.n_edges))


def _bucket(key_owner: np.ndarray, p: int, arrays, e_cap: int, fills):
    """Stable-sort ``arrays`` by owner and pack into (p, e_cap) blocks."""
    order = np.argsort(key_owner, kind="stable")
    counts = np.bincount(key_owner, minlength=p)
    out = [np.full((p, e_cap), f, dtype=np.int32) for f in fills]
    offs = np.zeros(p + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    for j in range(p):
        sel = order[offs[j]:offs[j + 1]]
        k = sel.shape[0]
        if k > e_cap:
            raise ValueError(f"shard {j} has {k} edges > capacity {e_cap}")
        for o, a in zip(out, arrays):
            o[j, :k] = a[sel]
    return out, counts


def shard_graph(src: np.ndarray, dst: np.ndarray, n: int, p: int,
                e_cap: int | None = None) -> ShardedGraph:
    """Partition a COO edge list across ``p`` shards (paper §2.1).

    ``e_cap`` defaults to the max per-shard edge count rounded up to 128.
    """
    part = Partition1D(n, p)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.size and (src.max() >= n or dst.max() >= n
                     or src.min() < 0 or dst.min() < 0):
        raise ValueError(f"edge endpoints must lie in [0, {n})")

    own_src = np.asarray(part.owner(src))
    own_dst = np.asarray(part.owner(dst))
    max_out = int(np.bincount(own_src, minlength=p).max()) if src.size else 0
    max_in = int(np.bincount(own_dst, minlength=p).max()) if src.size else 0
    cap_out = e_cap or max(_pad_to(max(max_out, 1), _ALIGN), _ALIGN)
    cap_in = e_cap or max(_pad_to(max(max_in, 1), _ALIGN), _ALIGN)

    (s_loc, d_glob), _ = _bucket(
        own_src, p, [np.asarray(part.local_id(src)), dst], cap_out, fills=(0, -1))
    (in_s_glob, in_d_loc), _ = _bucket(
        own_dst, p, [src, np.asarray(part.local_id(dst))], cap_in, fills=(-1, 0))

    return ShardedGraph(
        part=part,
        src_local=s_loc, dst_global=d_glob,
        in_src_global=in_s_glob, in_dst_local=in_d_loc,
        n_edges=int(src.size),
    )


@dataclasses.dataclass
class ShardedGraph2D:
    """2-D edge-partitioned graph: one padded COO block per grid cell.

    Block ``(i, j)`` (at linear index ``i*c + j``) holds every edge whose
    source is owned by grid row ``i`` and whose target is owned by grid
    column ``j``, pre-encoded for the two-phase level:

      src_rowlocal: (p, e_cap) int32 — source id relative to the row block
        (an index into the expand phase's ``(c*b, S)`` gathered frontier);
        0 in padding slots.
      dst_fold:     (p, e_cap) int32 — target in the transposed fold layout
        ``row_rank(owner(dst)) * b + local_id(dst)``; -1 = padding.

    The bottom-up level's in-edge blocks, bucketed by the owner of the
    target, are built on first use and cached (``bottom_up_blocks``), so
    dense and queue engines never pay for them:

      in_src_global: (p, in_e_cap) int32 — global source id; -1 = padding.
      in_dst_local:  (p, in_e_cap) int32 — target local id; -1 = padding.
      out_degree:    (p, b) int32 — out-degree of every owned vertex.
    """

    part: Partition2D
    src_rowlocal: np.ndarray
    dst_fold: np.ndarray
    n_edges: int

    @property
    def p(self) -> int:
        return self.part.p

    @property
    def e_cap(self) -> int:
        return self.src_rowlocal.shape[1]

    def edge_list(self):
        """Reconstruct the global COO edge list from the cell blocks
        (cell-bucketed order, not the original insertion order)."""
        part = self.part
        b, c = part.shard_size, part.c
        cell = np.arange(self.p, dtype=np.int64)[:, None]
        valid = self.dst_fold >= 0
        src = (self.src_rowlocal.astype(np.int64)
               + (cell // c) * part.row_block_size)[valid]
        vf = self.dst_fold.astype(np.int64)
        # invert fold_index: owner = row_rank * c + grid_col(cell)
        dst = (((vf // b) * c + cell % c) * b + vf % b)[valid]
        return src, dst

    def bottom_up_in_cap(self) -> int:
        """Padded per-cell capacity of the bottom-up in-edge blocks (a
        cached bincount; under degree skew it exceeds ``e_cap``)."""
        cached = self.__dict__.get("_bottom_up_blocks")
        if cached is not None:
            return cached[0].shape[1]
        cap = self.__dict__.get("_bottom_up_in_cap")
        if cap is None:
            src, dst = self.edge_list()
            own_d = np.asarray(self.part.owner(dst))
            max_in = (int(np.bincount(own_d, minlength=self.p).max())
                      if src.size else 0)
            cap = max(_pad_to(max(max_in, 1), _ALIGN), _ALIGN)
            self.__dict__["_bottom_up_in_cap"] = cap
        return cap

    def bottom_up_blocks(self):
        """(in_src_global, in_dst_local, out_degree), built and cached on
        first use (only the ``auto`` engine's bottom-up level reads them)."""
        cached = self.__dict__.get("_bottom_up_blocks")
        if cached is None:
            part = self.part
            src, dst = self.edge_list()
            own_d = np.asarray(part.owner(dst))
            (in_s_glob, in_d_loc), _ = _bucket(
                own_d, self.p, [src, np.asarray(part.local_id(dst))],
                self.bottom_up_in_cap(), fills=(-1, -1))
            out_degree = np.bincount(src, minlength=part.n).reshape(
                self.p, part.shard_size).astype(np.int32)
            cached = (in_s_glob, in_d_loc, out_degree)
            self.__dict__["_bottom_up_blocks"] = cached
        return cached

    @property
    def in_src_global(self) -> np.ndarray:
        return self.bottom_up_blocks()[0]

    @property
    def in_dst_local(self) -> np.ndarray:
        return self.bottom_up_blocks()[1]

    @property
    def out_degree(self) -> np.ndarray:
        return self.bottom_up_blocks()[2]

    @property
    def in_e_cap(self) -> int:
        return self.in_src_global.shape[1]

    def edge_counts(self) -> np.ndarray:
        """(p,) valid edges of each cell's block (cached)."""
        return _cached_counts(self, "_edge_counts", self.dst_fold)

    def in_edge_counts(self) -> np.ndarray:
        """(p,) valid in-edges of each bottom-up block (cached; builds
        the bottom-up blocks)."""
        return _cached_counts(self, "_in_edge_counts", self.in_src_global)

    def fingerprint(self) -> tuple:
        """Content identity (cached): a hash of the cell blocks."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            fp = _content_fingerprint(
                ("sharded_graph_2d", self.part.n_logical, self.part.r,
                 self.part.c, self.e_cap, self.n_edges),
                (self.src_rowlocal, self.dst_fold))
            self.__dict__["_fingerprint"] = fp
        return fp


def shard_graph_2d(src: np.ndarray, dst: np.ndarray, n: int, r: int, c: int,
                   e_cap: int | None = None) -> ShardedGraph2D:
    """Partition a COO edge list over an ``r x c`` grid (2-D edge blocks).

    Edge ``(u, v)`` goes to grid cell ``(grid_row(owner(u)),
    grid_col(owner(v)))``; ``e_cap`` defaults to the max per-cell edge
    count rounded up to 128, as in ``shard_graph``.
    """
    part = Partition2D(n, r, c)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.size and (src.max() >= n or dst.max() >= n
                     or src.min() < 0 or dst.min() < 0):
        raise ValueError(f"edge endpoints must lie in [0, {n})")

    own_s = np.asarray(part.owner(src))
    own_d = np.asarray(part.owner(dst))
    gi = np.asarray(part.grid_row(own_s))   # source's grid row
    gj = np.asarray(part.grid_col(own_d))   # target's grid column
    cell = gi * c + gj
    src_rowlocal = src - gi * part.row_block_size
    dst_fold = np.asarray(part.fold_index(dst))

    max_cell = int(np.bincount(cell, minlength=part.p).max()) if src.size else 0
    cap = e_cap or max(_pad_to(max(max_cell, 1), _ALIGN), _ALIGN)
    (s_row, d_fold), _ = _bucket(
        cell, part.p, [src_rowlocal, dst_fold], cap, fills=(0, -1))
    return ShardedGraph2D(part=part, src_rowlocal=s_row, dst_fold=d_fold,
                          n_edges=int(src.size))


def to_2d(graph: ShardedGraph, r: int, c: int) -> ShardedGraph2D:
    """The 2-D edge blocks of a 1-D sharded graph, built once per grid
    and cached on the graph (the same object for the same ``(r, c)``,
    thread-safe: engine-cache compiles may convert concurrently).  The
    view shares its parent's ``DeviceBlockCache``, so the two partitions
    of one graph dedup their uploads against one map under one lock.
    Requires ``r*c`` equal to the graph's shard count, so the vertex
    chunks line up exactly."""
    if r * c != graph.part.p:
        raise ValueError(f"grid {r}x{c} does not match the graph's "
                         f"p={graph.part.p} vertex chunks")
    with _TO2D_CREATE_LOCK:
        lock = graph.__dict__.setdefault("_to2d_lock", threading.Lock())
    with lock:
        cache = graph.__dict__.setdefault("_graph2d", {})
        g2 = cache.get((r, c))
        if g2 is None:
            src, dst = graph.edge_list()
            g2 = shard_graph_2d(src, dst, graph.part.n_logical, r, c)
            # not yet published, so plain assignment cannot race
            g2.__dict__["_device_blocks"] = device_block_cache(graph)
            cache[(r, c)] = g2
    return g2


def from_jax_arrays_2d(graph) -> ShardedGraph2D:
    """Carry a ``repro.graphs.ShardedGraph2D`` across to the port (the
    twin of ``from_jax_arrays``): its numpy cell blocks, so both engines
    traverse the identical grid.  The bottom-up blocks are rebuilt from
    them on first use, by the same rule."""
    part = graph.part
    return ShardedGraph2D(
        part=Partition2D(int(part.n_logical), int(part.r), int(part.c)),
        src_rowlocal=np.asarray(graph.src_rowlocal, np.int32),
        dst_fold=np.asarray(graph.dst_fold, np.int32),
        n_edges=int(graph.n_edges))


def shard_node_array(x: np.ndarray, part: Partition1D, fill=0.0) -> np.ndarray:
    """Pad a (n_logical, ...) vertex array to (part.n, ...) for sharding."""
    return part.pad_vertex_array(np.asarray(x), fill=fill)


def csr_from_coo(src: np.ndarray, dst: np.ndarray, n: int):
    """Host-side CSR (indptr, indices) sorted by src."""
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src_s, minlength=n), out=indptr[1:])
    return indptr, dst_s.astype(np.int64)


def block_sparse_adjacency(src: np.ndarray, dst: np.ndarray, n: int,
                           block: int = 128):
    """Blocked 0/1 adjacency (host numpy) for the ``bsr_spmm`` kernel.

    Returns (blocks, block_rows, block_cols, n_pad): ``blocks[k]`` is a
    dense (block, block) f32 tile of A[block_rows[k]*B :, block_cols[k]*B :].
    Only nonempty tiles are materialized (block-CSR, row-major order).
    """
    uniq, inv, nb = _block_keys(src, dst, n, block)
    blocks = np.zeros((uniq.shape[0], block, block), dtype=np.float32)
    blocks[inv, src % block, dst % block] = 1.0
    return (blocks, (uniq // nb).astype(np.int32),
            (uniq % nb).astype(np.int32), nb * block)
