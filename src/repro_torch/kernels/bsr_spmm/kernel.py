"""Block-sparse SpMM and bit-pack kernels (A2, A3) — wrappers of the
hand-written CUDA kernels in ``csrc/bfs_kernels.cu``.

One BFS level for a batch of S sources is the boolean-semiring product
``Y = A @ F`` (candidates = ``Y > 0``) with the adjacency in block-CSR:
only nonempty 128x128 tiles are stored, sorted by block row.  The CUDA
kernel needs a block-row pointer (CSR ``indptr`` over the sorted block
rows) instead of the TPU kernel's per-tile row ids; ``block_row_ptr``
builds it once, when an engine is compiled.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core.frontier import pack_bits
from repro_torch.kernels import _build
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref

DEFAULT_BLOCK = 128


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


def bsr_spmm(blocks: torch.Tensor, row_ptr: torch.Tensor,
             block_cols: torch.Tensor, x: torch.Tensor, *, n_rows_pad: int,
             block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Y = A @ X with A in block-CSR (``row_ptr`` from ``block_row_ptr``).

    blocks: (K, B, B) f32 tiles; row_ptr: (n_rows_pad/B + 1,) int32;
    block_cols: (K,) int32; x: (n_cols_pad, d) f32.  Returns
    ``(n_rows_pad, d)`` f32; block rows without a tile are zero.
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
    dev = _build.require_cuda("bsr_spmm", blocks, row_ptr, block_cols, x)
    y = torch.empty((n_rows_pad, d), dtype=torch.float32, device=dev)
    if y.numel():
        _build.launch("bfs_bsr_spmm", dev, blocks.data_ptr(),
                      row_ptr.data_ptr(), block_cols.data_ptr(), x.data_ptr(),
                      y.data_ptr(), n_rows_pad // block, d)
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
