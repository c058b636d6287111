"""Plain torch versions of the block-sparse SpMM (the oracle of kernel A2),
and an emulation of the A2 kernel's split-TF32 arithmetic for the tests."""

from __future__ import annotations

import torch


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


# TF32 keeps 10 of f32's 23 mantissa bits: clearing the 13 low bits
_TF32_MASK = -(1 << 13)                            # 0xFFFFE000 as int32


def tf32_trunc(v: torch.Tensor) -> torch.Tensor:
    """``v`` with its 13 low mantissa bits cleared: what the tensor core
    reads of an f32 word as TF32."""
    return (v.view(torch.int32) & _TF32_MASK).view(torch.float32)


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to TF32, to nearest with ties away from zero
    (``cvt.rna.tf32.f32``); for finite ``v``."""
    return ((v.view(torch.int32) + (1 << 12)) & _TF32_MASK).view(
        torch.float32)


def _quiet(v: torch.Tensor) -> torch.Tensor:
    """NaN with its top mantissa bit set, so TF32 truncation keeps it NaN;
    other values unchanged."""
    u = v.view(torch.int32)
    return torch.where((u & 0x7FFFFF) != 0, u | 0x400000, u).view(
        torch.float32)


def split_tf32(v: torch.Tensor):
    """The A2 kernel's split of f32 ``v`` into TF32 parts, as the operand
    pairs it multiplies: ``(hi, lo, finite)`` with ``hi = tf32_trunc(v)``
    and ``lo = tf32_rna(v - hi)`` where ``v`` is finite."""
    v = v.to(torch.float32).contiguous()
    finite = torch.isfinite(v)
    hi = tf32_trunc(v)
    lo = torch.where(finite, tf32_rna(v - hi), 0.0)
    return hi, lo, finite


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
    lo_op = torch.where(a_fin, a_lo, _quiet(blocks.to(torch.float32)))
    hi_op = torch.where(a_fin, a_hi, 0.0)
    x_hi, x_lo, x_fin = split_tf32(x)
    xp = torch.where(x_fin, x_hi, 0.0).reshape(n // b, b, d)[block_cols.long()]
    xq = x_lo.reshape(n // b, b, d)[block_cols.long()]
    xt = torch.where(x_fin, x_hi, _quiet(x.to(torch.float32)))
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
