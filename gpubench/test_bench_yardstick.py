"""CPU tests of the benchmark's yardstick: the generator, the TEPS count,
the plain reference BFS, the byte counts of the kernels, A1's reader and
the trace reading, each against a hand count or the port it was copied
from."""

from __future__ import annotations

import json
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpubench import graph500, harness, tracing, yardstick
from gpubench.reference import bfs as reference

INF = reference.INF


def hand_bfs(src, dst, n, root):
    adj = [[] for _ in range(n)]
    for u, v in zip(src.tolist(), dst.tolist()):
        adj[u].append(v)
    dist = [INF] * n
    dist[root] = 0
    todo = deque([root])
    while todo:
        u = todo.popleft()
        for v in adj[u]:
            if dist[v] == INF:
                dist[v] = dist[u] + 1
                todo.append(v)
    return np.array(dist, np.int32)


def undirected(pairs):
    src = np.array([a for a, b in pairs] + [b for a, b in pairs])
    dst = np.array([b for a, b in pairs] + [a for a, b in pairs])
    return src, dst


def test_the_generator_is_the_ports_bitwise():
    from repro_torch.graphs.generators import generate

    for scale, seed in ((8, 0), (10, 3)):
        want = generate("rmat", 1 << scale, seed=seed)
        got = graph500.rmat(scale, seed=seed)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_teps_counts_each_roots_component_once():
    # component {0, 1, 2}: 3 edges (a triangle); {3, 4}: 1 edge; 5 alone
    src, dst = undirected([(0, 1), (1, 2), (0, 2), (3, 4)])
    labels = graph500.component_labels(src, dst, 6)
    assert labels.tolist() == [0, 0, 0, 3, 3, 5]
    edges = graph500.component_edges(src, labels)
    assert edges.tolist() == [3, 3, 3, 1, 1, 0]
    g = graph500.Graph(n=6, src=src.astype(np.int32),
                       dst=dst.astype(np.int32), comp_edges=edges,
                       root_pool=np.flatnonzero(
                           np.bincount(src, minlength=6) > 0))
    assert g.root_pool.tolist() == [0, 1, 2, 3, 4]       # 5 is isolated
    assert g.n_undirected == 4
    # a batch of roots 0, 2, 3 traverses 3 + 3 + 1 edges
    assert int(g.comp_edges[[0, 2, 3]].sum()) == 7


def test_components_on_a_generated_graph_agree_with_a_hand_search():
    src, dst = graph500.rmat(9, edge_factor=4, seed=1)
    n = 1 << 9
    labels = graph500.component_labels(src, dst, n)
    for root in (0, 5, 77, 300):
        reach = hand_bfs(src, dst, n, root) < INF
        assert np.array_equal(labels == labels[root], reach)


@pytest.mark.parametrize("graph", ["chain", "star", "rmat"])
def test_the_reference_bfs_matches_a_hand_count(graph):
    if graph == "chain":
        n = 40
        src, dst = undirected([(i, i + 1) for i in range(n - 1)])
        roots = [0, 17, 39]
    elif graph == "star":
        n = 30
        src, dst = undirected([(0, i) for i in range(1, n)])
        roots = [0, 4, 29]
    else:
        n = 1 << 9
        src, dst = graph500.rmat(9, edge_factor=8, seed=2)
        roots = [0, 3, 100, 511]
    got = reference.bfs(src, dst, n, roots, block_edges=37)
    want = np.stack([hand_bfs(src, dst, n, r) for r in roots], axis=1)
    assert np.array_equal(got, want)
    if graph == "chain":
        assert got[39, 0] == 39 and got[0, 2] == 39
    if graph == "star":
        assert got[:, 1].max() == 2 and got[4, 1] == 0


def test_fold_update_bytes_by_hand():
    # two shards of 3 rows (one word each), roots 0 and 3 over the paths
    # 0-1-2 and 3-4; vertex 5 has no edge, so no root reaches it
    src, dst = undirected([(0, 1), (1, 2), (3, 4)])
    n, p, roots = 6, 2, [0, 3]
    shard = yardstick.partition(n, p)["shard"]
    assert shard == 3 and yardstick.words(shard) == 1
    labels = graph500.component_labels(src, dst, n)
    reached = yardstick.reached_pairs(labels, roots)
    assert reached == 2 + 1               # 1 and 2 from root 0, 4 from 3
    dist = reference.bfs(src, dst, n, roots)
    assert (dist[5] == INF).all()
    assert reached == int((dist < INF).sum()) - len(roots)
    levels = 3               # root 0's levels 1 and 2, then an empty one
    candidates = visited = next_words = p * 1 * 2 * 4
    want = levels * (candidates + visited + next_words) + 4 * reached
    assert yardstick.fold_update_bytes(p, shard, 2, levels, reached) == want
    assert want == 3 * 48 + 12
    # vertex 5 linked to 2 joins root 0's component: one pair, 4 bytes more
    src5, dst5 = undirected([(0, 1), (1, 2), (3, 4), (2, 5)])
    more = yardstick.reached_pairs(
        graph500.component_labels(src5, dst5, n), roots)
    assert yardstick.fold_update_bytes(p, shard, 2, levels, more) == want + 4


def test_reached_pairs_are_the_reference_bfs_reached_pairs():
    n = 1 << 9
    src, dst = graph500.rmat(9, edge_factor=2, seed=5)
    labels = graph500.component_labels(src, dst, n)
    pool = np.flatnonzero(np.bincount(src, minlength=n))
    roots = np.random.default_rng(0).choice(pool, 16, replace=False)
    dist = reference.bfs(src, dst, n, roots)
    assert 0 < yardstick.reached_pairs(labels, roots) == int(
        (dist < INF).sum()) - len(roots)
    assert (labels != labels[0]).any()    # more than one component


def test_fold_update_bytes_count_whole_words_three_times_a_level():
    # per level n * S / 8 bytes three times, plus 4 bytes a reached pair
    p, shard, s = 4, 1 << 18, 64
    per_level = yardstick.fold_update_bytes(p, shard, s, 1, 0)
    assert per_level == 3 * (p * shard) * s // 8
    assert yardstick.fold_update_bytes(p, shard, s, 24, 10) == (
        24 * per_level + 40)
    # 100 rows a shard take 4 words; 4 shards, 8 sources
    assert yardstick.fold_update_bytes(4, 100, 8, 1, 0) == 3 * 4 * 4 * 8 * 4


def a1_run(launches, seconds, traced, roots):
    """A run of the graph of ``test_fold_update_bytes_by_hand`` whose trace
    holds ``launches`` A1 launches taking ``seconds`` in all."""
    src, dst = undirected([(0, 1), (1, 2), (3, 4)])
    graph = graph500.Graph(n=6, src=src.astype(np.int32),
                           dst=dst.astype(np.int32),
                           comp_edges=np.zeros(6, np.int64),
                           root_pool=np.arange(5, dtype=np.int32))
    run = harness.Run(config={"partition": {"p": 2}},
                      traffic={"sources": 2}, graph=graph)
    run.trace = SimpleNamespace(kernel=lambda name: (
        launches if name == "fold_update_kernel" else 0, seconds))
    run.traced, run.traced_roots = traced, roots
    return run


def fold_update_reader():
    return harness.reader(Path(__file__).resolve().parents[1],
                          "fold_update_roofline")


def test_the_fold_update_reader_takes_no_layout_of_the_program():
    read = fold_update_reader()
    fronts = [torch.zeros(6, dtype=torch.bool)] * 3
    nbytes = 156                        # the hand count's batch
    seconds = yardstick.bound_s(2 * nbytes) * 4
    run = a1_run(6, seconds, [fronts, fronts], [[0, 3], [3, 0]])
    assert read(run) == pytest.approx(25.0)
    # the program's layout of what it traced does not enter the count:
    # int32 distances or a byte a (vertex, root) pair read the same
    other = [torch.full((6, 2), 7, dtype=torch.int32)] * 3
    masks = [torch.ones((6, 2), dtype=torch.uint8)] * 3
    assert read(a1_run(6, seconds, [other, masks], [[0, 3], [3, 0]])) == (
        read(run))


@pytest.mark.parametrize("launches", [0, 5, 7])
def test_the_fold_update_reader_reads_nothing_off_the_level_count(launches):
    fronts = [torch.zeros(6, dtype=torch.bool)] * 3
    run = a1_run(launches, 1e-3, [fronts, fronts], [[0, 3], [3, 0]])
    assert fold_update_reader()(run) is None
    run.trace = None
    assert fold_update_reader()(run) is None


def tile_layout(src, dst, n, p):
    """The port's own tiles of a graph (``bsr_bit_shards``)."""
    from repro_torch.graphs.formats import shard_graph

    g = shard_graph(src, dst, n, p)
    bits, cmask, brs, bcs, _, col_pad = g.bsr_bit_shards()
    return g, bits, cmask, bcs, col_pad


def test_the_tile_model_is_the_ports_layout():
    n, p = 1 << 10, 4
    src, dst = graph500.rmat(10, edge_factor=8, seed=4)
    g, bits, cmask, bcs, col_pad = tile_layout(src, dst, n, p)
    model = yardstick.TileModel(src, dst, n, p)
    assert model.kmax == bits.shape[1]
    assert model.n_tiles == int((cmask != 0).any(-1).sum())
    assert model.col_blocks * yardstick.BLOCK == col_pad

    # expand_bound's count on the port's arrays, for frontiers that reach
    # some tiles and skip others
    rng = np.random.default_rng(0)
    shard = n // p
    for density in (0.002, 0.02, 0.3):
        front = torch.from_numpy(rng.random(n) < density)
        words = torch.zeros((p, col_pad // 32), dtype=torch.int64)
        for v in torch.nonzero(front).flatten().tolist():
            words[v // shard, (v % shard) // 32] |= 1 << (v % 32)
        word_of = bcs.long()[..., None] * 4 + torch.arange(4)    # (p, K, 4)
        fw = torch.stack([words[j][word_of[j]] for j in range(p)])
        read = int(((fw & cmask.long()) != 0).any(-1).sum())
        assert model.tiles_read(front) == read
    # a frontier on vertices with no edges reads no tile at all
    isolated = np.flatnonzero(np.bincount(src, minlength=n) == 0)
    front = torch.zeros(n, dtype=torch.bool)
    front[torch.from_numpy(isolated)] = True
    assert isolated.size and model.tiles_read(front) == 0
    fixed = model.launch_bytes(8, 0)
    assert model.launch_bytes(8, 3) == fixed + 3 * 128 * 4 * 4
    k = p * model.kmax
    assert fixed == (k * 16 + 2 * k * 4 + p * col_pad // 32 * 8 * 4
                     + p * p * (shard // 32) * 8 * 4)


def write_trace(path, events):
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_the_trace_reader_splits_phases_and_finds_idle_time(tmp_path):
    def x(name, cat, ts, dur, tid=1, corr=None):
        ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
              "tid": tid}
        if corr is not None:
            ev["args"] = {"correlation": corr}
        return ev

    events = [
        x(tracing.WINDOW_RANGE, "user_annotation", 0, 1000),
        x("bfs.level", "user_annotation", 10, 900),
        x("bfs.expand", "user_annotation", 20, 100),
        x("cudaLaunchKernel", "cuda_runtime", 30, 5, corr=1),
        x("bfs.collective", "user_annotation", 200, 100),
        x("cudaLaunchKernel", "cuda_runtime", 210, 5, corr=2),
        x("aten::item", "cpu_op", 400, 500),
        x("bsr_expand_bits_kernel", "kernel", 100, 200, tid=7, corr=1),
        x("copy", "gpu_memcpy", 250, 100, tid=7, corr=2),
        x("outside", "kernel", 2000, 50, tid=7, corr=3),
    ]
    t = tracing.load(write_trace(tmp_path / "t.json", events))
    assert t.window_s == pytest.approx(1e-3)
    # busy: [100, 350] merged from two overlapping ops
    assert t.busy_s == pytest.approx(250e-6)
    assert t.phase_s["expand"] == pytest.approx(200e-6)
    assert t.phase_s["collective"] == pytest.approx(100e-6)
    assert t.kernel("bsr_expand_bits_kernel") == (1, pytest.approx(200e-6))
    assert [n for n, _ in t.top_ops()] == ["bsr_expand_bits_kernel", "copy"]
    idle = dict(t.top_idle())
    assert idle["bfs.level / aten::item"] == pytest.approx(650e-6)
    assert sum(idle.values()) == pytest.approx(750e-6)
    assert tracing.load(write_trace(tmp_path / "e.json", events[1:])).ops == []
