"""The benchmark's graphs: the Graph500 Kronecker generator, the graph
cache, and what the TEPS count needs (each vertex's component size in
undirected edges).

The generator is a copy of the port's ``graphs.generators.rmat`` (with
``dedupe_edges`` and ``to_undirected``), kept here so that a change to the
program cannot move the graphs it is measured on: the same parameters and
seed give the same edge list bitwise.  Like the port's, and unlike the
Graph500 reference code, it applies no vertex permutation.

A graph is generated on a cell's first run in a checkout and saved under
``gpubench/.cache/<config>/`` (int32 edge pairs, the component edge counts
and the pool of roots); later runs load it.  The cache key is the
configuration's generator section and seed, so a different graph is never
served from it.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_CHUNK = 1_000_000          # edges a generation chunk, as in the port


def to_undirected(src: np.ndarray, dst: np.ndarray):
    """Each undirected edge stored both ways."""
    return np.concatenate([src, dst]), np.concatenate([dst, src])


def dedupe_edges(src: np.ndarray, dst: np.ndarray, n: int):
    """Drop self loops and duplicate undirected edges; pairs come out
    canonical (``src < dst``), sorted by ``src * n + dst``."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    src, dst = np.minimum(src, dst), np.maximum(src, dst)
    key = src.astype(np.int64) * n + dst.astype(np.int64)
    _, idx = np.unique(key, return_index=True)
    return src[idx], dst[idx]


def rmat(scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0):
    """Graph500 Kronecker generator: ``n = 2**scale`` vertices and
    ``n * edge_factor`` drawn edges, deduplicated and made undirected.
    Returns int64 ``(src, dst)``, every edge both ways."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    left = n * edge_factor
    srcs, dsts = [], []
    while left > 0:
        kk = min(_CHUNK, left)
        s = np.zeros(kk, dtype=np.int64)
        d = np.zeros(kk, dtype=np.int64)
        for bit in range(scale):
            r = rng.random(kk)
            go_right = r >= a + c
            go_down = ((r >= a) & (r < a + c)) | (r >= a + b + c)
            s |= go_down.astype(np.int64) << bit
            d |= go_right.astype(np.int64) << bit
        srcs.append(s)
        dsts.append(d)
        left -= kk
    src, dst = dedupe_edges(np.concatenate(srcs), np.concatenate(dsts), n)
    return to_undirected(src, dst)


GENERATORS = {"rmat": rmat}


@dataclass
class Graph:
    """One configuration's graph as the benchmark holds it.

    ``src``, ``dst``: int32, every undirected edge both ways, no
    duplicates or self loops.  ``comp_edges[v]``: the undirected edges of
    ``v``'s connected component (what Graph500 counts as traversed from a
    root ``v``).  ``root_pool``: the vertices of degree >= 1, ascending.
    """

    n: int
    src: np.ndarray
    dst: np.ndarray
    comp_edges: np.ndarray
    root_pool: np.ndarray

    @property
    def n_undirected(self) -> int:
        return self.src.shape[0] // 2


def component_labels(src, dst, n: int, device="cpu"):
    """Connected-component labels (the least vertex id of each component)
    of a symmetric edge list, by min-label propagation with pointer
    jumping, in plain torch on ``device``.  Returns an int64 numpy array."""
    import torch

    s = torch.as_tensor(src, device=device).long()
    d = torch.as_tensor(dst, device=device).long()
    labels = torch.arange(n, device=device)
    while True:
        new = labels.scatter_reduce(0, d, labels[s], "amin")
        while True:                               # jump to the root label
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, labels):
            return labels.cpu().numpy()
        labels = new


def component_edges(src: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Each vertex's component size in undirected edges (a symmetric
    edge list holds each one twice)."""
    per_label = np.bincount(labels[src], minlength=labels.shape[0])
    return (per_label // 2)[labels].astype(np.int64)


def build(spec: dict, device="cpu") -> Graph:
    """Generate a configuration's graph from its ``generator`` section and
    ``graph_seed``."""
    gen = dict(spec["generator"])
    kind = gen.pop("kind")
    n = 1 << gen["scale"]
    src, dst = GENERATORS[kind](seed=spec["graph_seed"], **gen)
    labels = component_labels(src, dst, n, device)
    deg = np.bincount(src, minlength=n)
    return Graph(n=n, src=src.astype(np.int32), dst=dst.astype(np.int32),
                 comp_edges=component_edges(src, labels),
                 root_pool=np.flatnonzero(deg > 0).astype(np.int32))


_ARRAYS = ("src", "dst", "comp_edges", "root_pool")


def cache_key(spec: dict) -> str:
    text = json.dumps({"generator": spec["generator"],
                       "graph_seed": spec["graph_seed"], "format": 1},
                      sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def load(spec: dict, cache_dir: Path, device="cpu") -> tuple[Graph, bool]:
    """The configuration's graph from ``cache_dir/<name>/``, generated and
    saved there first if it is missing or was made from other parameters.
    Returns ``(graph, generated)``."""
    where = Path(cache_dir) / spec["name"]
    key = cache_key(spec)
    meta = where / "meta.json"
    if meta.is_file() and json.loads(meta.read_text()).get("key") == key:
        arrays = {k: np.load(where / f"{k}.npy") for k in _ARRAYS}
        return Graph(n=json.loads(meta.read_text())["n"], **arrays), False
    g = build(spec, device)
    tmp = where.with_name(f"{where.name}.partial")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    for k in _ARRAYS:
        np.save(tmp / f"{k}.npy", getattr(g, k))
    (tmp / "meta.json").write_text(json.dumps({"key": key, "n": g.n}))
    shutil.rmtree(where, ignore_errors=True)
    os.replace(tmp, where)
    return g, True
