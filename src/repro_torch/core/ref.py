"""BFS oracles of the port: the serial numpy ``bfs_reference`` (a copy of
``repro.core.ref``'s) and ``validate_bfs``, a vectorized check of a
distance matrix against the Graph500 validation rules, for sizes at which
a serial Python BFS is far too slow."""

from __future__ import annotations

import numpy as np
import torch

INF = 2 ** 30


def bfs_reference(src: np.ndarray, dst: np.ndarray, n: int, sources) -> np.ndarray:
    """Level-synchronous serial BFS. Returns (n, S) int32 distances."""
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    order = np.argsort(src, kind="stable")
    src_s, dst_s = np.asarray(src)[order], np.asarray(dst)[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src_s, minlength=n), out=indptr[1:])

    out = np.full((n, sources.shape[0]), INF, dtype=np.int32)
    for j, s0 in enumerate(sources):
        dist = out[:, j]
        dist[s0] = 0
        frontier = [int(s0)]
        level = 1
        while frontier:
            nxt = []
            for u in frontier:
                for v in dst_s[indptr[u]:indptr[u + 1]]:
                    if dist[v] == INF:
                        dist[v] = level
                        nxt.append(int(v))
            frontier = nxt
            level += 1
    return out


def validate_bfs(src, dst, sources, dist, *, chunk: int = 8) -> None:
    """Check ``(n, S)`` BFS distances against the Graph500 rules; raise
    ``ValueError`` naming the first violation.

    For every column ``j`` with source ``sources[j]``:
      * every value is INF (unreached) or a depth in ``[0, n)``, and the
        source is the only vertex at depth 0;
      * on every edge ``u -> v`` with ``u`` reached, ``v`` is reached and
        ``d(v) <= d(u) + 1`` (on a symmetric edge list: reached ends come
        in pairs and ``|d(u) - d(v)| <= 1``);
      * every reached non-source vertex ``v`` has an in-neighbour ``u``
        with ``d(u) = d(v) - 1``.

    Runs on ``dist``'s device (a numpy ``dist`` runs on the CPU), ``chunk``
    columns at a time to bound the ``(E, chunk)`` intermediates.
    """
    d_all = torch.as_tensor(dist)
    dev = d_all.device
    n, s = d_all.shape
    src_t = torch.as_tensor(np.asarray(src, dtype=np.int64)).to(dev)
    dst_t = torch.as_tensor(np.asarray(dst, dtype=np.int64)).to(dev)
    roots = torch.as_tensor(np.asarray(sources, dtype=np.int64)).to(dev)
    if roots.shape != (s,):
        raise ValueError(f"{roots.numel()} sources for {s} dist columns")
    cols = torch.arange(s, device=dev)

    bad_val = (d_all != INF) & ((d_all < 0) | (d_all >= n))
    if bool(bad_val.any()):
        v, j = (int(i) for i in bad_val.nonzero()[0])
        raise ValueError(f"column {j}: vertex {v} has depth "
                         f"{int(d_all[v, j])}, neither INF nor in [0, {n})")
    if bool((d_all[roots, cols] != 0).any()):
        j = int((d_all[roots, cols] != 0).nonzero()[0, 0])
        raise ValueError(f"column {j}: source {int(roots[j])} is not at "
                         "depth 0")
    zeros = (d_all == 0).sum(dim=0)
    if bool((zeros != 1).any()):
        j = int((zeros != 1).nonzero()[0, 0])
        raise ValueError(f"column {j}: {int(zeros[j])} vertices at depth 0")

    for c0 in range(0, s, chunk):
        d = d_all[:, c0:c0 + chunk]
        du, dv = d[src_t], d[dst_t]                      # (E, k)
        reached_u = du < INF
        bad = reached_u & ((dv == INF) | (dv > du + 1))
        if bool(bad.any()):
            e, j = (int(i) for i in bad.nonzero()[0])
            raise ValueError(
                f"column {c0 + j}: edge {int(src_t[e])}->{int(dst_t[e])} "
                f"has depths {int(du[e, j])} -> {int(dv[e, j])}")
        parent = (reached_u & (du == dv - 1)).to(torch.uint8)
        has_parent = torch.zeros(d.shape, dtype=torch.uint8, device=dev)
        has_parent.scatter_reduce_(0, dst_t[:, None].expand_as(parent),
                                   parent, "amax")
        orphan = (d > 0) & (d < INF) & (has_parent == 0)
        if bool(orphan.any()):
            v, j = (int(i) for i in orphan.nonzero()[0])
            raise ValueError(f"column {c0 + j}: vertex {v} at depth "
                             f"{int(d[v, j])} has no in-neighbour one "
                             "level up")
