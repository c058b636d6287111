"""Plain torch versions of the block-sparse SpMM (the oracle of kernel A2),
and an emulation of the A2 kernel's split-TF32 arithmetic for the tests."""

from __future__ import annotations

import torch

from repro_torch.kernels.tf32 import (quiet, split_tf32, tf32_rna,
                                     tf32_trunc)


def bsr_spmm_ref(blocks: torch.Tensor, block_rows: torch.Tensor,
                 block_cols: torch.Tensor, x: torch.Tensor, *,
                 n_rows_pad: int) -> torch.Tensor:
    """Gather ``x``'s block rows per tile, batched matmul with the tiles,
    ``index_add_`` into zeroed output rows.  A block row with no tile
    stays zero.  O(K·B·d) memory."""
    k, b, _ = blocks.shape
    n, d = x.shape
    xb = x.to(torch.float32).reshape(n // b, b, d)
    contrib = torch.bmm(blocks.to(torch.float32), xb[block_cols.long()])
    y = torch.zeros((n_rows_pad // b, b, d), dtype=torch.float32,
                    device=x.device)
    y.index_add_(0, block_rows.long(), contrib)
    return y.reshape(n_rows_pad, d)


def bsr_spmm_split_ref(blocks: torch.Tensor, block_rows: torch.Tensor,
                       block_cols: torch.Tensor, x: torch.Tensor, *,
                       n_rows_pad: int) -> torch.Tensor:
    """Emulation of the A2 kernel's arithmetic (for the tests): per tile
    ``lo_a @ hi_x + hi_a @ lo_x + hi_a @ hi_x`` in that order, each product
    of TF32 values exact in f32, summed in f32, then the tiles of a block
    row in tile order.  Non-finite values as the kernel takes them: a
    non-finite x enters only through its (quiet) hi, a non-finite tile
    value only through the lo operand, against x's finite hi."""
    k, b, _ = blocks.shape
    n, d = x.shape
    a_hi, a_lo, a_fin = split_tf32(blocks)
    lo_op = torch.where(a_fin, a_lo, quiet(blocks.to(torch.float32)))
    hi_op = torch.where(a_fin, a_hi, 0.0)
    x_hi, x_lo, x_fin = split_tf32(x)
    xp = torch.where(x_fin, x_hi, 0.0).reshape(n // b, b, d)[block_cols.long()]
    xq = x_lo.reshape(n // b, b, d)[block_cols.long()]
    xt = torch.where(x_fin, x_hi, quiet(x.to(torch.float32)))
    xt = xt.reshape(n // b, b, d)[block_cols.long()]
    contrib = torch.bmm(lo_op, xp)
    contrib += torch.bmm(hi_op, xq)
    contrib += torch.bmm(hi_op, xt)
    y = torch.zeros((n_rows_pad // b, b, d), dtype=torch.float32,
                    device=x.device)
    y.index_add_(0, block_rows.long(), contrib)
    return y.reshape(n_rows_pad, d)


def frontier_expand_ref(blocks, block_rows, block_cols, frontier, *,
                        n_rows_pad):
    """Boolean-semiring BFS expansion oracle: candidates = (A @ F) > 0."""
    y = bsr_spmm_ref(blocks, block_rows, block_cols,
                     frontier.to(torch.float32), n_rows_pad=n_rows_pad)
    return (y > 0).to(torch.uint8)


def unpack_bit_tiles(bits: torch.Tensor) -> torch.Tensor:
    """``(..., 128, 4)`` one-bit tiles (``bits[..., c, q]`` bit ``b`` =
    row ``32 q + b`` of column ``c``) to ``(..., 128, 128)`` f32 0/1 tiles
    indexed ``[row, col]``, as ``ShardedGraph.bsr_shards`` has them."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    b = bits[..., None] >> shifts                      # (..., col, q, 32)
    b &= 1
    return b.flatten(-2).transpose(-1, -2).to(torch.float32)
