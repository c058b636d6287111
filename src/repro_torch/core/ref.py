"""BFS oracles of the port: the serial numpy ``bfs_reference`` and the
host simulation of the 2-D algorithm ``bfs_reference_2d`` (copies of
``repro.core.ref``'s), and ``validate_bfs``, a vectorized check of a
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


def bfs_reference_2d(src: np.ndarray, dst: np.ndarray, n: int, sources,
                     r: int, c: int, mode: str = "dense",
                     queue_cap: int = 1024, queue_threshold: float = 1 / 64,
                     bottom_up_threshold: float = 0.05,
                     local_update: bool = True, dedupe: bool = True,
                     return_schedule: bool = False):
    """Host simulation of 2-D edge-partitioned BFS on an r x c grid.

    ``mode="dense"`` simulates the two-phase level: for every grid cell
    (i, j), expand cell-local edges through grid row i's frontier segment
    into a fold-ordered candidate array, OR-merge partial candidates down
    each grid column (the fold phase), then apply the owner-computes
    update chunk by chunk.

    ``mode="queue"`` / ``mode="auto"`` additionally simulate the
    direction-optimizing hybrid schedule with the engine's per-level
    decision rule (replicated frontier vertex/edge statistics against the
    same cutoffs), the sparse level's §5.1 local-update exclusion and
    cap-bounded per-row-rank buckets with overflow escalation to dense,
    and the bottom-up level over owner-side in-edges.

    Returns (n, S) int32 distances (logical range only); with
    ``return_schedule=True`` also a list of per-level dicts
    ``{"level", "kind", "overflowed"}`` mirroring the engine's
    ``mode_counts`` / ``overflowed`` stats.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    s_count = sources.shape[0]
    if mode not in ("dense", "queue", "auto"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "queue" and s_count != 1:
        raise ValueError("queue frontier supports a single source")
    p = r * c
    b = -(-n // p)                      # chunk size (ceil)
    n_pad = b * p
    row_blk = c * b                     # vertices per grid row

    # Bucket edges into grid cells with the engine's encodings: source
    # relative to its row block, target in the transposed fold layout.
    own_s, own_d = src // b, dst // b
    gi, gj = own_s // c, own_d % c
    u_row = src - gi * row_blk
    v_fold = (own_d // c) * b + (dst - own_d * b)
    cells = {}
    for i in range(r):
        for j in range(c):
            sel = (gi == i) & (gj == j)
            cells[i, j] = (u_row[sel], v_fold[sel])

    # Owner-side in-edge buckets (bottom-up) + per-vertex out-degrees
    # (the frontier-edge statistic of the auto decision).
    in_cells = {k: (src[own_d == k], dst[own_d == k] - k * b)
                for k in range(p)}
    out_deg = np.bincount(src, minlength=n_pad)
    e_total = src.shape[0]
    q_cutoff = max(1, int(queue_threshold * e_total))
    bu_cutoff = max(1, int(bottom_up_threshold * n))

    dist = np.full((n_pad, s_count), INF, dtype=np.int32)
    frontier = np.zeros((n_pad, s_count), dtype=bool)
    dist[sources, np.arange(s_count)] = 0
    frontier[sources, np.arange(s_count)] = True

    def apply_owner_update(folded_by_col, level, new):
        # folded_by_col[j]: (r*b, S) column-merged fold-layout candidates
        for j in range(c):
            for rr in range(r):
                chunk = slice((rr * c + j) * b, (rr * c + j + 1) * b)
                upd = (folded_by_col[j][rr * b:(rr + 1) * b]
                       & (dist[chunk] == INF))
                dist[chunk][upd] = level
                new[chunk] |= upd

    def dense_level(level, new):
        folded = []
        for j in range(c):
            fold = np.zeros((r * b, s_count), dtype=bool)   # column merge
            for i in range(r):
                frow = frontier[i * row_blk:(i + 1) * row_blk]
                ul, vf = cells[i, j]
                cand = np.zeros((r * b, s_count), dtype=bool)
                np.logical_or.at(cand, vf, frow[ul])
                fold |= cand
            folded.append(fold)
        apply_owner_update(folded, level, new)

    def bottom_up_level(level, new):
        for k in range(p):
            sg, dl = in_cells[k]
            chunk = slice(k * b, (k + 1) * b)
            cand = np.zeros((b, s_count), dtype=bool)
            np.logical_or.at(cand, dl, frontier[sg])
            upd = cand & (dist[chunk] == INF)
            dist[chunk][upd] = level
            new[chunk] |= upd

    def queue_level(level, new):
        """Sparse level; returns True when any device overflowed (the
        engine then re-runs the whole level densely)."""
        overflow = any(frontier[k * b:(k + 1) * b, 0].sum() > queue_cap
                       for k in range(p))
        cand = np.zeros((n_pad,), dtype=bool)
        for i in range(r):
            frow = frontier[i * row_blk:(i + 1) * row_blk, 0]
            for j in range(c):
                ul, vf = cells[i, j]
                tgt = vf[frow[ul]]
                if dedupe:
                    tgt = np.unique(tgt)
                if local_update:
                    mine = tgt // b == i
                    cand[(i * c + j) * b + (tgt[mine] - i * b)] = True
                    tgt = tgt[~mine]
                for rr in range(r):
                    ids = tgt[tgt // b == rr]
                    if ids.shape[0] > queue_cap:
                        overflow = True
                        ids = ids[:queue_cap]
                    cand[(rr * c + j) * b + (ids - rr * b)] = True
        if overflow:
            return True
        upd = cand & (dist[:, 0] == INF)
        dist[upd, 0] = level
        new[upd, 0] = True
        return False

    schedule = []
    level = 1
    while frontier.any():
        f_verts = int(frontier.sum())
        f_edges = int((out_deg * frontier[:, 0]).sum())
        if mode == "dense":
            kind = "dense"
        elif mode == "queue":
            kind = "queue"
        else:
            big = f_verts > bu_cutoff
            tiny = f_edges < q_cutoff
            kind = ("bottom_up" if big else
                    "queue" if (tiny and s_count == 1) else "dense")
        new = np.zeros_like(frontier)
        overflowed = False
        if kind == "queue":
            overflowed = queue_level(level, new)
            if overflowed:      # escalate, still counted as a queue level
                new = np.zeros_like(frontier)
                dense_level(level, new)
        elif kind == "bottom_up":
            bottom_up_level(level, new)
        else:
            dense_level(level, new)
        schedule.append({"level": level, "kind": kind,
                         "overflowed": overflowed})
        frontier = new
        level += 1
    if return_schedule:
        return dist[:n], schedule
    return dist[:n]


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
