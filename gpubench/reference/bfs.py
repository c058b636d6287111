"""The plain reference BFS: hop distances from a batch of roots over the
benchmark's own symmetric edge list, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
reads the edge list that ``graph500.load`` gives both sides.  Level by
level, the frontier's out-edges are gathered in blocks of edges (so the
``(edges, roots)`` temporaries stay bounded), counted into each target
with ``index_add_`` and merged into the distances where a target is still
unreached.  Unreached vertices hold ``INF`` (``2**30``), the value the
configurations' guarantee names.
"""

from __future__ import annotations

import numpy as np
import torch

INF = 2 ** 30


def bfs(src, dst, n: int, roots, *, device="cpu",
        block_edges: int = 1 << 22) -> np.ndarray:
    """``(n, len(roots))`` int32 hop distances from each root, until no
    root reaches a new vertex.  Returns a host array."""
    dev = torch.device(device)
    s_all = torch.as_tensor(np.asarray(src), device=dev).long()
    d_all = torch.as_tensor(np.asarray(dst), device=dev).long()
    roots_t = torch.as_tensor(np.asarray(roots), device=dev).long()
    k = roots_t.shape[0]
    cols = torch.arange(k, device=dev)
    dist = torch.full((n, k), INF, dtype=torch.int32, device=dev)
    dist[roots_t, cols] = 0
    frontier = torch.zeros((n, k), dtype=torch.bool, device=dev)
    frontier[roots_t, cols] = True
    level = 0
    while True:
        level += 1
        # only edges leaving a vertex in some root's frontier can reach
        active = frontier.any(dim=1)[s_all].nonzero().squeeze(1)
        if active.numel() == 0:
            break
        hits = torch.zeros((n, k), dtype=torch.int32, device=dev)
        for lo in range(0, active.numel(), block_edges):
            e = active[lo:lo + block_edges]
            hits.index_add_(0, d_all[e], frontier[s_all[e]].to(torch.int32))
        frontier = (hits > 0) & (dist == INF)
        del hits
        if not bool(frontier.any()):
            break
        dist[frontier] = level
    return dist.cpu().numpy()
