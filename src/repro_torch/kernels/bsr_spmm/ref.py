"""Plain torch versions of the block-sparse SpMM (the oracle of kernel A2),
and an emulation of the A2 kernel's split-TF32 arithmetic for the tests."""

from __future__ import annotations

import torch

from repro_torch.kernels.tf32 import needs_least_hi, split_whole_lo


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
    row in tile order.  Tiles and x are split by ``tf32.split_whole_lo``,
    as the kernel splits them (a non-finite value in lo whole, hi 0; a
    value below 2^-136 with hi ``copysign(2^-136, v)`` where
    ``tf32.needs_least_hi(x)``, as the kernel then takes the rule)."""
    k, b, _ = blocks.shape
    n, d = x.shape
    least = bool(needs_least_hi(x))
    a_hi, a_lo = split_whole_lo(blocks, least)
    x_hi, x_lo = (part.reshape(n // b, b, d)[block_cols.long()]
                  for part in split_whole_lo(x, least))
    contrib = torch.bmm(a_lo, x_hi)
    contrib += torch.bmm(a_hi, x_lo)
    contrib += torch.bmm(a_hi, x_hi)
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
