"""Public wrappers around the block-sparse SpMM kernel (the port of
``repro.kernels.bsr_spmm.ops``)."""

from __future__ import annotations

import torch

from repro_torch.core.frontier import pack_bits
from repro_torch.kernels.bsr_spmm.kernel import (DEFAULT_BLOCK, bitpack_words,
                                                 block_row_ptr, bsr_spmm)
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref


def spmm(blocks, block_rows, block_cols, x, *, n_rows_pad,
         block: int = DEFAULT_BLOCK, row_ptr=None):
    """Block-sparse A @ X.  ``row_ptr`` (from ``block_row_ptr``) may be
    passed in when the caller built it once; otherwise it is built here."""
    if row_ptr is None:
        row_ptr = block_row_ptr(block_rows, block_cols, n_rows_pad // block,
                                x.shape[0] // block)
    return bsr_spmm(blocks, row_ptr, block_cols, x, n_rows_pad=n_rows_pad,
                    block=block)


def frontier_expand(blocks, block_rows, block_cols, frontier, *, n_rows_pad,
                    block: int = DEFAULT_BLOCK, row_ptr=None):
    """Batched BFS frontier expansion: ``(A @ F) > 0`` as uint8.

    frontier: (n_cols_pad, S) uint8 — S simultaneous sources.
    """
    y = spmm(blocks, block_rows, block_cols, frontier.to(torch.float32),
             n_rows_pad=n_rows_pad, block=block, row_ptr=row_ptr)
    return (y > 0).to(torch.uint8)


def pack_candidates(y: torch.Tensor, n_valid: int,
                    n_blocks: int) -> torch.Tensor:
    """Per-owner-blocked candidate words of ``(..., >= n_valid, S)`` f32
    expansion sums: ``n_blocks`` segments of ``n_valid / n_blocks`` rows,
    each padded to whole words (``frontier.pack_bits`` semantics).

    A word-aligned segment packs with the ``bitpack_words`` kernel
    (blocked == flat packing then); an unaligned one with ``pack_bits``.
    """
    seg = n_valid // n_blocks
    if seg * n_blocks != n_valid:
        raise ValueError(f"{n_valid} rows do not split into {n_blocks} blocks")
    yv = y[..., :n_valid, :]
    if seg % 32 == 0:
        *lead, _, s = yv.shape
        words = bitpack_words(yv.contiguous().reshape(-1, s))
        return words.reshape(*lead, n_valid // 32, s)
    return pack_bits(yv > 0, n_blocks)


def frontier_expand_packed(blocks, block_rows, block_cols, frontier, *,
                           n_rows_pad, n_valid, n_blocks,
                           block: int = DEFAULT_BLOCK, row_ptr=None):
    """Kernel expansion emitting *packed* candidate words
    (``(n_blocks * ceil(seg/32), S)`` int32, see ``pack_candidates``)."""
    y = spmm(blocks, block_rows, block_cols, frontier.to(torch.float32),
             n_rows_pad=n_rows_pad, block=block, row_ptr=row_ptr)
    return pack_candidates(y, n_valid, n_blocks)


def spmm_reference(blocks, block_rows, block_cols, x, *, n_rows_pad):
    return bsr_spmm_ref(blocks, block_rows, block_cols, x,
                        n_rows_pad=n_rows_pad)
