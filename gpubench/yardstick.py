"""The benchmark's own arithmetic: the H100's memory bandwidth and the
bytes each hand-written kernel on the BFS path has to move.

The bandwidth is copied from the port's ``launch/roofline.py`` (the one
peak a BFS kernel's bound uses: each is bound by bytes) and the
expansion's byte bound from ``chip_smoke.py``'s ``expand_bound``, so a
change to the program cannot move the yardstick.  Every count here comes
from the benchmark's own edge list, its component labels and the
partition's arithmetic, never from the program's tiles or state.
"""

from __future__ import annotations

import numpy as np
import torch

# One NVIDIA H100 SXM (80 GB HBM3) at its full 700 W power limit, as
# NVIDIA's data sheet states it (dense rates, no sparsity).
HBM_BW = 3.35e12              # B/s, HBM3

BLOCK = 128                   # the bit tiles' edge
WORD = 4                      # bytes of an int32


def _pad(x: int, to: int) -> int:
    return -(-x // to) * to


def words(bits: int) -> int:
    """32-bit words that hold ``bits`` bits."""
    return -(-bits // 32)


def partition(n_logical: int, p: int) -> dict:
    """The 1-D block partition: each of ``p`` shards owns ``shard``
    consecutive ids; ids are padded to ``n = p * shard``."""
    shard = -(-n_logical // p)
    return {"p": p, "shard": shard, "n": shard * p}


def fold_update_bytes(p: int, shard: int, s: int, levels: int,
                      reached: int) -> int:
    """The least bytes that kernel A1 (the owner update) has to move over
    ``levels`` launches, each over ``p`` stacked shards of ``shard`` rows
    and ``s`` sources, in batches whose roots reach ``reached`` (vertex,
    root) pairs at level 1 or later (``reached_pairs``).

    A level reads the merged candidate words and the visited state, one
    bit a pair, and writes the next frontier's words: three times ``p *
    words(shard) * s`` words.  Each reached pair takes one 4-byte ``dist``
    write, once, at the level that first reaches it.  Reading ``dist``,
    rewriting its unchanged entries and a byte a pair of new mask are one
    design's choices, not work the level's result needs, so they are not
    counted: this is a floor that any implementation of A1's contract
    moves, and no faster A1 can read above 100% of it.  It takes only
    counts, never a tensor of the program, so the program's layout of
    ``dist`` or of its masks cannot move it."""
    return levels * 3 * p * words(shard) * s * WORD + reached * WORD


def reached_pairs(labels: np.ndarray, roots) -> int:
    """The (vertex, root) pairs that a BFS from each of ``roots`` reaches
    past the root itself: the vertices of each root's connected component
    (``labels`` from ``graph500.component_labels``) less one, summed."""
    size = np.bincount(labels, minlength=labels.shape[0])
    return int((size[labels[np.asarray(roots)]] - 1).sum())


class TileModel:
    """The one-bit tiles of ``bsr_expand_bits`` as the edge list gives
    them: shard ``owner(u)``'s tile ``(v // 128, local(u) // 128)`` holds
    every edge ``u -> v``; shards are padded to the fullest one's tile
    count.  ``tile_of_edge`` maps each edge to its tile's index."""

    def __init__(self, src, dst, n_logical: int, p: int, device="cpu"):
        part = partition(n_logical, p)
        self.p, self.shard = p, part["shard"]
        self.row_blocks = _pad(part["n"], BLOCK) // BLOCK
        self.col_blocks = _pad(self.shard, BLOCK) // BLOCK
        u = torch.as_tensor(np.asarray(src), device=device).long()
        v = torch.as_tensor(np.asarray(dst), device=device).long()
        owner, local = u // self.shard, u % self.shard
        key = ((owner * self.row_blocks + v // BLOCK) * self.col_blocks
               + local // BLOCK)
        tiles, self.tile_of_edge = torch.unique(key, return_inverse=True)
        per_shard = torch.bincount(
            tiles // (self.row_blocks * self.col_blocks), minlength=p)
        self.n_tiles = int(tiles.numel())
        self.kmax = max(1, int(per_shard.max()))
        self.src = u

    def tiles_read(self, frontier_any: torch.Tensor) -> int:
        """Tiles whose column mask meets some source's frontier word: those
        holding an edge out of a vertex in ``frontier_any`` (a bool over
        the logical vertices, the OR of every source's frontier).  A tile
        the kernel skips is never counted."""
        hit = frontier_any.to(self.src.device)[self.src]
        seen = torch.zeros(self.n_tiles, dtype=torch.bool,
                           device=self.src.device)
        seen[self.tile_of_edge[hit]] = True
        return int(seen.sum())

    def launch_bytes(self, s: int, tiles_read: int) -> int:
        """One ``bsr_expand_bits`` launch over every shard: the column masks
        and block indices of every (padded) tile, the frontier words, the
        output words, and ``tiles_read`` tiles of 128 x 128 bits."""
        k = self.p * self.kmax
        fixed = k * (BLOCK // 32) * WORD + 2 * k * WORD
        fwords = self.p * (self.col_blocks * BLOCK // 32) * s * WORD
        out = self.p * self.p * words(self.shard) * s * WORD
        return fixed + fwords + out + tiles_read * BLOCK * (BLOCK // 32) * WORD


def bound_s(nbytes: float) -> float:
    """Least seconds to move ``nbytes`` through HBM."""
    return nbytes / HBM_BW
