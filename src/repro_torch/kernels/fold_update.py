"""Fused fold-merge + owner-update tail of a dense BFS level (kernel A1).

The port of ``repro.kernels.fold_update``.  After the dense exchange, the
unfused level tail is ``unpack_bits`` -> compare with INF -> write depths;
this fuses them into one pass over the merged candidate words: each word
is bit-tested against the 32 dist rows it covers, depths are written, and
the newly discovered vertices come out both as the byte mask and re-packed
as words.

* ``fold_update`` — the dispatcher: on a CUDA tensor it launches the
  hand-written kernel (``csrc/bfs_kernels.cu`` ``fold_update_kernel``) or
  raises; on a CPU tensor it runs ``fold_update_plain``.
* ``fold_update_plain`` — the same function in plain torch ops (the
  ``_fold_update_jnp`` expression); the CPU tests hold it against the JAX
  kernel, and the card holds the kernel against it.

Words are int32 holding the uint32 bit pattern (``frontier.pack_bits``):
bit ``i`` of word ``w`` is row ``w*32 + i``; pad bits beyond ``m`` must be
zero.  Both take optional leading batch dimensions (stacked shards).
"""

from __future__ import annotations

import torch

from repro_torch.core.frontier import INF, pack_bits, packed_words
from repro_torch.kernels import _build


def _check(words: torch.Tensor, dist: torch.Tensor):
    if words.dtype != torch.int32 or dist.dtype != torch.int32:
        raise ValueError(f"fold_update takes int32 words and dist "
                         f"(got {words.dtype}, {dist.dtype})")
    if words.dim() < 2 or words.shape[:-2] != dist.shape[:-2]:
        raise ValueError(f"words {tuple(words.shape)} and dist "
                         f"{tuple(dist.shape)} batch dimensions differ")
    w, s = words.shape[-2:]
    m = dist.shape[-2]
    if w != packed_words(m):
        raise ValueError(f"words rows {w} != packed_words({m})="
                         f"{packed_words(m)}")
    if dist.shape[-1] != s:
        raise ValueError(f"dist batch {dist.shape[-1]} != words batch {s}")


def fold_update_plain(words: torch.Tensor, dist: torch.Tensor, level: int,
                      *, inplace: bool = False):
    """Plain torch version of the fused tail (see ``fold_update``)."""
    _check(words, dist)
    *lead, w, s = words.shape
    m = dist.shape[-2]
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-2) >> shifts[:, None]) & 1     # (..., W, 32, S)
    bits = bits.reshape(*lead, w * 32, s)[..., :m, :]
    new = (bits > 0) & (dist == INF)
    dist2 = (dist.masked_fill_(new, level) if inplace
             else dist.masked_fill(new, level))
    return dist2, new.to(torch.uint8), pack_bits(new)


def fold_update(words: torch.Tensor, dist: torch.Tensor, level: int, *,
                inplace: bool = False):
    """Fused dense-tail update: merge words into dist, emit next frontier.

    Args:
      words: ``(..., W, S)`` int32 merged candidate words of this shard's
        owned vertex block, ``W == packed_words(m)``, pad bits zero.
      dist: ``(..., m, S)`` int32 depths (INF = undiscovered).
      level: depth to write for newly discovered vertices.
      inplace: write the new depths into ``dist`` itself (the engine's
        reused buffer) instead of a new tensor.

    Returns ``(dist', new_mask, new_words)``: the ``(..., m, S)`` int32
    depths, the ``(..., m, S)`` uint8 newly-discovered mask and the
    ``(..., W, S)`` int32 words ``pack_bits(new_mask)``.
    """
    if words.device.type == "cpu":
        return fold_update_plain(words, dist, level, inplace=inplace)
    _check(words, dist)
    dev = _build.require_cuda("fold_update", words, dist)
    *lead, w, s = words.shape
    m = dist.shape[-2]
    batch = dist.numel() // max(1, m * s)
    dist_out = dist if inplace else torch.empty_like(dist)
    new = torch.empty(dist.shape, dtype=torch.uint8, device=dev)
    new_words = torch.empty_like(words)
    if words.numel() and dist.numel():
        _build.launch("bfs_fold_update", dev, words.data_ptr(),
                      dist.data_ptr(), dist_out.data_ptr(), new.data_ptr(),
                      new_words.data_ptr(), batch, w, m, s, int(level))
        fold_update.launches += 1
    return dist_out, new, new_words


fold_update.launches = 0
