"""Host-side graph generators (paper §3: star, Erdős-Rényi, small-world).

A copy of ``repro.graphs.generators`` for the PyTorch port: numpy only, so
``generate(kind, n, seed)`` gives the same arrays bitwise in both packages.

The paper generates graphs with BOOST on the host and reports that naive
generation of 4M-vertex graphs OOMs (§3.1); their fix is chunked generation
("graph is generated for 1000000 vertices and then concatenated").  We keep
the same discipline: every generator below works in bounded-size chunks of
edges so peak host memory is O(chunk), never O(E) intermediates beyond the
output arrays themselves.

Generators return COO edge arrays ``(src, dst)`` as int64 numpy.  They are
host-side by design — real distributed systems build/load graphs outside
the accelerator hot loop (paper §6 suggests exactly this split as future
work: "by reading it from file ... free processors from graph production").

Also includes the Graph500 RMAT/Kronecker generator as a beyond-paper
workload (the scale-free family the paper motivates with Facebook-like
graphs in §1).
"""

from __future__ import annotations

import numpy as np

_CHUNK = 1_000_000  # edges per generation chunk (mirrors the paper's fix)


def _rng(seed):
    return np.random.default_rng(seed)


def to_undirected(src: np.ndarray, dst: np.ndarray):
    """Symmetrize an edge list (each undirected edge stored both ways)."""
    return np.concatenate([src, dst]), np.concatenate([dst, src])


def dedupe_edges(src: np.ndarray, dst: np.ndarray, n: int, canonical: bool = True):
    """Remove duplicate edges and self loops. O(E log E) host-side.

    With ``canonical=True`` pairs are treated as undirected ((u,v)==(v,u)),
    so a later ``to_undirected`` cannot reintroduce duplicates.
    """
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if canonical:
        src, dst = np.minimum(src, dst), np.maximum(src, dst)
    key = src.astype(np.int64) * n + dst.astype(np.int64)
    _, idx = np.unique(key, return_index=True)
    return src[idx], dst[idx]


def star_graph(n: int, seed: int = 0):
    """Star on n vertices: vertex 0 is the hub (paper §4.1 workload).

    Worst case for 1-D partitioning: every edge is incident to one vertex,
    so the hub's owner does O(n) expansion work in level 1 while everyone
    else idles — the paper's star table (fig. 3) is dominated by exactly
    this imbalance.
    """
    leaves = np.arange(1, n, dtype=np.int64)
    hub = np.zeros(n - 1, dtype=np.int64)
    return to_undirected(hub, leaves)


def chain_graph(n: int, seed: int = 0):
    """Path 0-1-2-...-(n-1), each edge stored both ways.

    The diameter extreme opposite the star: BFS runs n-1 levels with a
    single-vertex frontier, so per-level overheads (collective latency,
    loop fixed costs) dominate — a worst case for level-synchronous
    engines and the deepest traversal the parity tests exercise.
    """
    base = np.arange(n - 1, dtype=np.int64)
    return to_undirected(base, base + 1)


def erdos_renyi(n: int, avg_degree: float = 16.0, seed: int = 0):
    """G(n, M) Erdős-Rényi with M = n*avg_degree/2 undirected edges.

    Sampled in chunks; duplicates are removed at the end (for sparse
    graphs the duplicate rate is ~M/n^2, negligible).
    """
    rng = _rng(seed)
    m = int(n * avg_degree / 2)
    srcs, dsts = [], []
    left = m
    while left > 0:
        k = min(_CHUNK, left)
        srcs.append(rng.integers(0, n, size=k, dtype=np.int64))
        dsts.append(rng.integers(0, n, size=k, dtype=np.int64))
        left -= k
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    src, dst = dedupe_edges(src, dst, n)
    return to_undirected(src, dst)


def small_world(n: int, k: int = 8, beta: float = 0.1, seed: int = 0):
    """Watts-Strogatz small-world: ring lattice with k neighbors, rewire
    probability beta (paper §4.3 workload). Chunked over vertex ranges."""
    rng = _rng(seed)
    half = k // 2
    srcs, dsts = [], []
    for lo in range(0, n, _CHUNK):
        hi = min(lo + _CHUNK, n)
        base = np.arange(lo, hi, dtype=np.int64)
        for off in range(1, half + 1):
            s = base
            d = (base + off) % n
            rew = rng.random(hi - lo) < beta
            d = np.where(rew, rng.integers(0, n, size=hi - lo, dtype=np.int64), d)
            srcs.append(s)
            dsts.append(d)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    src, dst = dedupe_edges(src, dst, n)
    return to_undirected(src, dst)


def rmat(scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0):
    """Graph500 Kronecker generator: n = 2^scale, E = n*edge_factor.

    Produces the heavy-tailed degree distribution typical of the social
    graphs the paper targets.  Chunked: each chunk draws its bit decisions
    independently.
    """
    rng = _rng(seed)
    n = 1 << scale
    m = n * edge_factor
    srcs, dsts = [], []
    left = m
    while left > 0:
        kk = min(_CHUNK, left)
        s = np.zeros(kk, dtype=np.int64)
        d = np.zeros(kk, dtype=np.int64)
        for bit in range(scale):
            r = rng.random(kk)
            # quadrant probabilities (a, b, c, d)
            go_right = r >= a + c  # columns b+d
            go_down = ((r >= a) & (r < a + c)) | (r >= a + b + c)
            s |= go_down.astype(np.int64) << bit
            d |= go_right.astype(np.int64) << bit
        srcs.append(s)
        dsts.append(d)
        left -= kk
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    src, dst = dedupe_edges(src, dst, n)
    return to_undirected(src, dst)


def batched_molecules(n_nodes: int, n_edges: int, batch: int, d_feat: int, seed: int = 0):
    """A batch of random small graphs packed into one disjoint-union graph
    (for the ``molecule`` GNN shape cell). Returns (src, dst, feats, pos)."""
    rng = _rng(seed)
    srcs, dsts = [], []
    for g in range(batch):
        off = g * n_nodes
        s = rng.integers(0, n_nodes, size=n_edges // 2, dtype=np.int64) + off
        d = rng.integers(0, n_nodes, size=n_edges // 2, dtype=np.int64) + off
        srcs += [s, d]
        dsts += [d, s]
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    n_total = batch * n_nodes
    feats = rng.standard_normal((n_total, d_feat)).astype(np.float32)
    pos = rng.standard_normal((n_total, 3)).astype(np.float32)
    return src, dst, feats, pos


GENERATORS = {
    "star": star_graph,
    "chain": chain_graph,
    "erdos_renyi": erdos_renyi,
    "small_world": small_world,
    "rmat": rmat,
}


# short spec aliases accepted anywhere a graph kind is parsed
ALIASES = {"er": "erdos_renyi", "sw": "small_world"}


def generate(kind: str, n: int, seed: int = 0, **kw):
    kind = ALIASES.get(kind, kind)
    if kind == "star":
        return star_graph(n, seed=seed)
    if kind == "chain":
        return chain_graph(n, seed=seed)
    if kind == "erdos_renyi":
        return erdos_renyi(n, seed=seed, **kw)
    if kind == "small_world":
        return small_world(n, seed=seed, **kw)
    if kind == "rmat":
        scale = int(np.ceil(np.log2(max(n, 2))))
        src, dst = rmat(scale, seed=seed, **kw)
        keep = (src < n) & (dst < n)  # 2^scale may exceed the requested n
        return src[keep], dst[keep]
    raise KeyError(f"unknown graph kind {kind!r}; have {sorted(GENERATORS)}")
