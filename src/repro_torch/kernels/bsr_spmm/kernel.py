"""Block-sparse SpMM, bit-pack and boolean expansion kernels — wrappers
of the hand-written CUDA kernels in ``csrc/bfs_kernels.cu``.

One BFS level for a batch of S sources is the boolean-semiring product
``Y = A @ F`` (candidates = ``Y > 0``) with the adjacency in block-CSR:
only nonempty 128x128 tiles are stored, sorted by block row.  The CUDA
kernels need a block-row pointer (CSR ``indptr`` over the sorted block
rows) instead of the TPU kernel's per-tile row ids; ``block_row_ptr``
builds it once, when an engine is compiled.

* ``bsr_spmm`` (A2) — ``Y = A @ X`` over f32 tiles, for ``ops.spmm``:
  split-TF32 ``wgmma`` products of TMA-fed tile panels, a persistent grid
  over ``bsr_spmm_work``'s list.
* ``bitpack_words`` (A3) — a ``> 0`` mask to packed words.
* ``bsr_expand_bits`` — the engine's expansion: one-bit tiles
  (``ShardedGraph.bsr_bit_shards``) and a packed frontier in, the packed
  candidate words of ``(A @ F) > 0`` out, with no f32 tile or mask.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core.frontier import pack_bits, packed_words, unpack_bits
from repro_torch.kernels import _build
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref, unpack_bit_tiles
from repro_torch.kernels.tf32 import needs_least_hi

DEFAULT_BLOCK = 128
SPMM_D_TILE = 64           # X columns a work item of the A2 kernel
# the A2 kernel names tile rows by int32 TMA coordinates (tile * 128)
SPMM_MAX_TILES = 2 ** 24


def block_row_ptr(block_rows: torch.Tensor, block_cols: torch.Tensor,
                  n_block_rows: int, n_block_cols: int) -> torch.Tensor:
    """CSR ``indptr`` (int32, ``n_block_rows + 1``) over sorted tile rows.

    Validates the tile indices once (sorted rows in range, columns in
    range), so the kernel launches that follow can trust them.
    """
    rows = block_rows.to(torch.int64)
    cols = block_cols.to(torch.int64)
    if rows.numel():
        if bool((rows[1:] < rows[:-1]).any()):
            raise ValueError("block rows must be sorted")
        if int(rows.min()) < 0 or int(rows.max()) >= n_block_rows:
            raise ValueError(f"block rows outside [0, {n_block_rows})")
        if int(cols.min()) < 0 or int(cols.max()) >= n_block_cols:
            raise ValueError(f"block cols outside [0, {n_block_cols})")
    bounds = torch.arange(n_block_rows + 1, device=rows.device)
    return torch.searchsorted(rows, bounds).to(torch.int32)


def bsr_spmm_work(row_ptr: torch.Tensor, d: int) -> torch.Tensor:
    """The A2 kernel's work list: every (block row, ``SPMM_D_TILE``-column
    tile of X) item once, as ``row * n_d_tiles + j``, block rows by tile
    count from largest to smallest (ties by row), the column tiles of a
    row together.  Empty rows are listed: their items write zeros.  int32,
    on ``row_ptr``'s device."""
    counts = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    n_dt = -(-d // SPMM_D_TILE)
    order = torch.sort(counts, descending=True, stable=True).indices
    cols = torch.arange(n_dt, dtype=torch.int64, device=row_ptr.device)
    return (order[:, None] * n_dt + cols).reshape(-1).to(torch.int32)


def bsr_spmm(blocks: torch.Tensor, row_ptr: torch.Tensor,
             block_cols: torch.Tensor, x: torch.Tensor, *, n_rows_pad: int,
             block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Y = A @ X with A in block-CSR (``row_ptr`` from ``block_row_ptr``).

    blocks: (K, B, B) f32 tiles; row_ptr: (n_rows_pad/B + 1,) int32;
    block_cols: (K,) int32; x: (n_cols_pad, d) f32.  Returns
    ``(n_rows_pad, d)`` f32; block rows without a tile are zero.  The
    kernel computes in split TF32 (``ref.bsr_spmm_split_ref`` emulates
    it): exact on integer operands, within f32 rounding otherwise.  Its
    build with ``tf32``'s 2^-136 hi runs where ``tf32.needs_least_hi(x)``
    (a device flag, no host read), the other build elsewhere.
    """
    k, b0, b1 = blocks.shape
    n_x, d = x.shape
    if not b0 == b1 == block or n_x % block or n_rows_pad % block:
        raise ValueError(f"tiles {tuple(blocks.shape)}, x rows {n_x} and "
                         f"{n_rows_pad} output rows must be {block}-aligned")
    if row_ptr.shape != (n_rows_pad // block + 1,) or block_cols.shape != (k,):
        raise ValueError(f"row_ptr {tuple(row_ptr.shape)} / block_cols "
                         f"{tuple(block_cols.shape)} do not match {k} tiles "
                         f"and {n_rows_pad // block} block rows")
    if x.device.type == "cpu":
        counts = (row_ptr[1:] - row_ptr[:-1]).long()
        rows = torch.repeat_interleave(torch.arange(counts.numel()), counts)
        return bsr_spmm_ref(blocks, rows, block_cols, x,
                            n_rows_pad=n_rows_pad)
    if block != DEFAULT_BLOCK:
        raise ValueError(f"the CUDA kernel is built for {DEFAULT_BLOCK}-wide "
                         f"tiles, not {block}")
    if (blocks.dtype, x.dtype) != (torch.float32, torch.float32) or (
            row_ptr.dtype, block_cols.dtype) != (torch.int32, torch.int32):
        raise ValueError("bsr_spmm takes f32 tiles and x, int32 indices")
    if k >= SPMM_MAX_TILES:
        raise ValueError(f"{k} tiles: the kernel addresses tile rows by "
                         f"int32, at most {SPMM_MAX_TILES - 1} tiles")
    if blocks.data_ptr() % 16:
        raise ValueError("bsr_spmm loads tiles by TMA: their base must be "
                         "16-byte aligned")
    dev = _build.require_cuda("bsr_spmm", blocks, row_ptr, block_cols, x)
    y = torch.empty((n_rows_pad, d), dtype=torch.float32, device=dev)
    if y.numel():
        work = bsr_spmm_work(row_ptr, d)
        least = needs_least_hi(x)
        _build.launch("bfs_bsr_spmm", dev, blocks.data_ptr(),
                      row_ptr.data_ptr(), block_cols.data_ptr(),
                      work.data_ptr(), x.data_ptr(), y.data_ptr(),
                      least.data_ptr(), k, work.numel(),
                      -(-d // SPMM_D_TILE), d)
        bsr_spmm.launches += 1
    return y


bsr_spmm.launches = 0


def bitpack_words_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``bitpack_words``: ``pack_bits(mask > 0)``."""
    return pack_bits(mask > 0)


def bitpack_words(mask: torch.Tensor) -> torch.Tensor:
    """Pack a ``(32*W, S)`` f32 candidate mask (``> 0``) into ``(W, S)``
    int32 words (uint32 bits, bit ``i`` = row ``i``, LSB-first).

    The row count must be 32-aligned; unaligned segmented packing uses
    ``frontier.pack_bits`` in the ops wrapper.
    """
    m, s = mask.shape
    if m % 32:
        raise ValueError(f"bitpack_words needs 32-aligned rows (got {m})")
    if mask.device.type == "cpu":
        return bitpack_words_plain(mask)
    if mask.dtype != torch.float32:
        raise ValueError(f"bitpack_words takes an f32 mask (got {mask.dtype})")
    dev = _build.require_cuda("bitpack_words", mask)
    out = torch.empty((m // 32, s), dtype=torch.int32, device=dev)
    if out.numel():
        _build.launch("bfs_bitpack", dev, mask.data_ptr(), out.data_ptr(),
                      m // 32, s)
        bitpack_words.launches += 1
    return out


bitpack_words.launches = 0


def expand_tiles_read(col_mask: torch.Tensor, block_cols: torch.Tensor,
                      fwords: torch.Tensor) -> int:
    """The tiles ``bsr_expand_bits`` reads: those whose column mask meets
    the OR over the sources of their block column's frontier words."""
    front_any = torch.zeros((fwords.shape[0],), dtype=torch.int32,
                            device=fwords.device)
    for col in fwords.unbind(1):
        front_any |= col
    front = front_any.view(-1, DEFAULT_BLOCK // 32)[block_cols.long()]
    return int(((col_mask & front) != 0).any(1).sum())


def bsr_expand_bits_plain(bits, col_mask, row_ptr, block_rows, block_cols,
                          fwords, *, n_valid: int, n_blocks: int,
                          rows_per_group: int | None = None,
                          tiles_read: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Plain torch version of ``bsr_expand_bits``: unpack the bit tiles and
    the frontier to 0/1, ``bsr_spmm_ref``, then pack each group's first
    ``n_valid`` rows with ``pack_bits``.  ``col_mask`` is the kernel's
    skip hint: the product does not read it, and ``tiles_read`` (where
    given) counts by it the tiles the kernel would read."""
    if tiles_read is not None and bits.shape[0]:
        tiles_read += expand_tiles_read(col_mask, block_cols, fwords)
    s = fwords.shape[1]
    x = unpack_bits(fwords, fwords.shape[0] * 32)
    n_rows_pad = (row_ptr.shape[0] - 1) * DEFAULT_BLOCK
    rows_per_group = rows_per_group or n_rows_pad
    y = bsr_spmm_ref(unpack_bit_tiles(bits), block_rows, block_cols, x,
                     n_rows_pad=n_rows_pad)
    y = y.reshape(n_rows_pad // rows_per_group, rows_per_group, s)
    return pack_bits(y[:, :n_valid] > 0, n_blocks).reshape(-1, s)


def bsr_expand_bits(bits: torch.Tensor, col_mask: torch.Tensor,
                    row_ptr: torch.Tensor, block_rows: torch.Tensor,
                    block_cols: torch.Tensor, fwords: torch.Tensor, *,
                    n_valid: int, n_blocks: int,
                    rows_per_group: int | None = None,
                    tiles_read: torch.Tensor | None = None) -> torch.Tensor:
    """Packed candidate words of ``(A @ F) > 0`` from one-bit tiles.

    bits: ``(K, 128, 4)`` int32 tiles, ``bits[t, c, q]`` bit ``b`` = row
    ``32 q + b`` of column ``c``; col_mask: ``(K, 4)`` int32, bit ``c`` of
    word ``w`` set where column ``32 w + c`` of the tile holds an edge
    (both from ``ShardedGraph.bsr_bit_shards``); row_ptr: ``(R + 1,)``
    int32 over ``R`` block rows, from ``block_row_ptr`` (which checks the
    tiles' block rows and columns); block_rows, block_cols: ``(K,)``
    int32, each tile's block row (sorted) and column; fwords: ``(C * 4, S)`` int32, the frontier of the ``C`` block columns
    packed along the vertex axis (``pack_bits`` of the zero-padded
    ``(128 C, S)`` mask).

    The ``128 R`` rows fall into groups of ``rows_per_group`` (default:
    one group); the first ``n_valid`` rows of each group split into
    ``n_blocks`` segments, each packed into ``ceil(seg / 32)`` words, so
    a group's output is ``pack_bits(cand[:n_valid], n_blocks)`` — the
    JAX ``ops.frontier_expand_packed``.  Returns ``(groups * n_blocks *
    ceil(seg / 32), S)`` int32 carrying uint32 bits.

    tiles_read: a ``(1,)`` int64 counter on the tiles' device, or None.
    Where given, the launch adds the tiles it read: those whose column mask
    meets the OR over the sources of their block column's frontier words
    (``expand_tiles_read``), each counted once whatever ``S``.
    """
    k = bits.shape[0]
    n_rows_pad = (row_ptr.shape[0] - 1) * DEFAULT_BLOCK
    rows_per_group = rows_per_group or n_rows_pad
    tensors = (bits, col_mask, row_ptr, block_rows, block_cols, fwords)
    if any(t.dtype != torch.int32 for t in tensors):
        raise ValueError("bsr_expand_bits takes int32 tiles, mask, indices "
                         "and frontier words (got "
                         f"{[str(t.dtype) for t in tensors]})")
    if (bits.shape != (k, DEFAULT_BLOCK, DEFAULT_BLOCK // 32)
            or col_mask.shape != (k, DEFAULT_BLOCK // 32)
            or block_rows.shape != (k,) or block_cols.shape != (k,)):
        raise ValueError(f"bits {tuple(bits.shape)}, col_mask "
                         f"{tuple(col_mask.shape)}, block_rows "
                         f"{tuple(block_rows.shape)} and block_cols "
                         f"{tuple(block_cols.shape)} are not {k} "
                         f"{DEFAULT_BLOCK}-wide bit tiles")
    if (fwords.dim() != 2 or fwords.shape[0] % (DEFAULT_BLOCK // 32)
            or (k and not fwords.shape[0])):
        raise ValueError(f"frontier words {tuple(fwords.shape)} do not "
                         f"cover whole {DEFAULT_BLOCK}-column blocks")
    if (rows_per_group % DEFAULT_BLOCK or n_rows_pad % rows_per_group
            or not 0 < n_valid <= rows_per_group or n_blocks < 1
            or n_valid % n_blocks):
        raise ValueError(f"{n_rows_pad} rows in groups of {rows_per_group}, "
                         f"{n_valid} valid rows in {n_blocks} segments: "
                         "not a blocked layout")
    if tiles_read is not None and (
            tiles_read.dtype != torch.int64 or tiles_read.shape != (1,)
            or tiles_read.device != bits.device):
        raise ValueError("tiles_read is a (1,) int64 counter on the tiles' "
                         f"device (got {tiles_read.dtype} "
                         f"{tuple(tiles_read.shape)} on {tiles_read.device})")
    s = fwords.shape[1]
    seg = n_valid // n_blocks
    w = packed_words(seg)
    groups = n_rows_pad // rows_per_group
    if all(t.device.type == "cpu" for t in tensors):
        return bsr_expand_bits_plain(bits, col_mask, row_ptr, block_rows,
                                     block_cols, fwords, n_valid=n_valid,
                                     n_blocks=n_blocks,
                                     rows_per_group=rows_per_group,
                                     tiles_read=tiles_read)
    if k >= 2 ** 31:
        raise ValueError(f"{k} tiles: the kernel numbers tiles in int32")
    dev = _build.require_cuda("bsr_expand_bits", *tensors)
    if bits.data_ptr() % 16 or col_mask.data_ptr() % 16:
        raise ValueError("bsr_expand_bits reads tiles and column masks in "
                         "16-byte words: both must be 16-byte aligned")
    out = torch.zeros((groups * n_blocks * w, s), dtype=torch.int32,
                      device=dev)
    if k and out.numel():       # no tile: every candidate word stays zero
        # scratch: each frontier word's OR over the sources
        front_any = torch.empty((fwords.shape[0],), dtype=torch.int32,
                                device=dev)
        _build.launch("bfs_bsr_expand_bits", dev, bits.data_ptr(),
                      col_mask.data_ptr(), block_rows.data_ptr(),
                      block_cols.data_ptr(), fwords.data_ptr(),
                      out.data_ptr(), front_any.data_ptr(),
                      None if tiles_read is None else tiles_read.data_ptr(),
                      k,
                      fwords.shape[0], rows_per_group // DEFAULT_BLOCK,
                      n_valid, n_blocks, seg, w, s)
        bsr_expand_bits.launches += 1
    return out


bsr_expand_bits.launches = 0
