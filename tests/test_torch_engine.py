"""The port's dense 1-D engine (plan -> compile -> run) against the serial
oracle and the JAX engine: dist bitwise, levels and comm_bytes equal,
across graphs, source counts, wire formats, the fused tail, the kernel
expansion and LocalMesh shard counts."""

import gc
import weakref

import numpy as np
import pytest
import torch

from repro.core import BFSOptions as JOptions
from repro.core import engine as jengine
from repro.core import plan as jplan
from repro.core.ref import bfs_reference as j_bfs_reference
from repro.graphs import shard_graph as j_shard_graph
from repro_torch.core import BFSOptions, LocalMesh, plan
from repro_torch.core.engine import resolve_device
from repro_torch.core.ref import bfs_reference, validate_bfs
from repro_torch.graphs import (from_jax_arrays, generate, shard_graph,
                                to_2d)

# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

# n is never a multiple of 32 * p, so every run has padding vertices
GRAPHS = {
    "er": ("erdos_renyi", 301, {"avg_degree": 5.0}),
    "star": ("star", 301, {}),
    "chain": ("chain", 75, {}),
    "rmat": ("rmat", 301, {"edge_factor": 8}),
}
SOURCES = [0, 7, 50, 33]
OPTIONS = {
    "bytes": BFSOptions(wire_format="bytes"),
    "packed_fused": BFSOptions(wire_format="packed"),
    "packed_unfused": BFSOptions(wire_format="packed", use_fused_tail=False),
    "kernel_bytes": BFSOptions(use_kernel=True, wire_format="bytes"),
    "kernel_packed": BFSOptions(use_kernel=True, wire_format="packed"),
}


@pytest.fixture(scope="module")
def jax_runs():
    """Per graph: edges, the oracle's dist, and the JAX engine (p = 1,
    default options) run for one source and for all four."""
    out = {}
    for key, (kind, n, kw) in GRAPHS.items():
        src, dst = generate(kind, n, seed=2, **kw)
        srcs = [v % n for v in SOURCES]
        jg = j_shard_graph(src, dst, n, 1)
        eng = jplan(jg, JOptions(), num_sources=4).compile()
        runs = {}
        for s in (1, 4):
            r = eng.run(srcs[:s])
            runs[s] = (r.dist_host, r.run_stats.to_host())
        out[key] = (src, dst, n, srcs, jg, bfs_reference(src, dst, n, srcs),
                    runs)
    return out


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("opt", list(OPTIONS))
@pytest.mark.parametrize("p", [1, 2, 4])
def test_engine_matches_oracle_and_jax(jax_runs, graph, s, opt, p):
    src, dst, n, srcs, jg, want, jruns = jax_runs[graph]
    opts = OPTIONS[opt]
    g = from_jax_arrays(jg) if p == 1 else shard_graph(src, dst, n, p)
    pl = plan(g, opts, num_sources=s, device="cpu")
    res = pl.compile().run(srcs[:s])
    np.testing.assert_array_equal(res.dist_host, want[:, :s])
    jdist, jstats = jruns[s]
    np.testing.assert_array_equal(res.dist_host, jdist)
    stats = res.run_stats.to_host()
    assert stats["levels"] == jstats["levels"]
    assert stats["mode_counts"] == {"dense": jstats["levels"], "queue": 0,
                                    "bottom_up": 0}
    # comm_bytes: the JAX byte model of the strategy the JAX plan rules
    # resolve for these options, summed per level in float32 as the JAX
    # loop sums it (p = 1 ships nothing, and the JAX run above agrees)
    jopts = JOptions(wire_format=opts.wire_format,
                     use_fused_tail=opts.use_fused_tail,
                     use_kernel=opts.use_kernel)
    part = g.part
    jst = jengine._resolve_strategy(
        "dense", jopts.dense_exchange, (part.n, p, s, 1, (p,)),
        jopts.wire_format)
    assert pl.dense_strategy.name == jst.name
    assert pl.use_fused_tail == jengine._resolve_fused_tail(
        jopts.use_fused_tail, "dense", jst.wire)
    acc = np.float32(0)
    for _ in range(stats["levels"]):
        acc = np.float32(acc + np.float32(jst.bytes_model(part.n, p, s, 1,
                                                          (p,))))
    assert stats["comm_bytes"] == float(acc)
    if p == 1:
        assert stats["comm_bytes"] == jstats["comm_bytes"] == 0.0


def test_plan_describe_matches_jax_plan(jax_runs):
    src, dst, n, srcs, jg, _, _ = jax_runs["er"]
    for opts in OPTIONS.values():
        jo = JOptions(wire_format=opts.wire_format,
                      use_fused_tail=opts.use_fused_tail,
                      use_kernel=opts.use_kernel)
        td = plan(from_jax_arrays(jg), opts, num_sources=4,
                  device="cpu").describe()
        jd = jplan(jg, jo, num_sources=4).describe()
        shared = set(jd) - {"roofline"}
        assert shared <= set(td)
        for k in shared:
            assert td[k] == jd[k], k


def test_fan_in_of_256_from_one_level():
    """Vertex t has 256 in-edges, all from level-1 vertices: a wrapping
    uint8 sum would read 0 candidates and never reach it."""
    mids = np.arange(1, 257)
    t = 257
    src = np.concatenate([np.zeros(256, np.int64), mids])
    dst = np.concatenate([mids, np.full(256, t)])
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    n = 258
    want = bfs_reference(src, dst, n, [0])
    for p in (1, 2):
        for opts in (BFSOptions(), BFSOptions(wire_format="bytes")):
            res = plan(shard_graph(src, dst, n, p), opts,
                       device="cpu").compile().run([0])
            np.testing.assert_array_equal(res.dist_host, want)
            assert res.dist_host[t, 0] == 2


@pytest.mark.parametrize("strategy", ["allgather_merge", "reduce_scatter",
                                      "hierarchical", "alltoall_direct"])
@pytest.mark.parametrize("wire", ["bytes", "packed"])
def test_every_dense_strategy_on_a_two_axis_mesh(jax_runs, strategy, wire):
    src, dst, n, srcs, _, want, _ = jax_runs["er"]
    mesh = LocalMesh((2, 2), ("data", "model"), "cpu")
    g = shard_graph(src, dst, n, 4)
    pl = plan(g, BFSOptions(dense_exchange=strategy, wire_format=wire),
              mesh=mesh, num_sources=4)
    assert pl.axes_sizes == (2, 2)
    res = pl.compile().run(srcs)
    np.testing.assert_array_equal(res.dist_host, want)


def test_engine_reuses_buffers_and_flags_stale_results(jax_runs):
    src, dst, n, srcs, jg, want, _ = jax_runs["rmat"]
    eng = plan(from_jax_arrays(jg), BFSOptions(), num_sources=4,
               device="cpu").compile()
    r1 = eng.run(srcs)
    buf = r1.dist
    np.testing.assert_array_equal(r1.dist_host, want)
    r2 = eng.run(srcs[:2])
    r3 = eng.run([srcs[3]])
    assert r2.dist is buf and r3.dist is buf     # one (n, S) buffer
    np.testing.assert_array_equal(r1.dist_host, want)   # cached copy
    with pytest.raises(RuntimeError, match="reused"):
        r2.dist_host
    np.testing.assert_array_equal(r3.dist_host, want[:, 3:])
    assert eng.trace_count == eng.compile_traces
    st = r3.stats()
    assert st.visited == int((want[:, 3] < 2 ** 30).sum())
    assert not st.overflowed and st.sieve_hits == 0


@pytest.mark.parametrize("p", [1, 4])
def test_dropped_kernel_engine_frees_its_tiles(jax_runs, p):
    """A use_kernel engine holds no reference to itself: dropping it (and
    its results) frees the bit tiles at once, with no garbage collection,
    so a later engine on the card has their memory."""
    src, dst, n, srcs, _, want, _ = jax_runs["rmat"]
    eng = plan(shard_graph(src, dst, n, p), BFSOptions(use_kernel=True),
               num_sources=4, device="cpu").compile()
    res = eng.run(srcs)
    np.testing.assert_array_equal(res.dist_host, want)
    tiles = weakref.ref(eng.kernel_arrays[0])
    gc.disable()
    try:
        del eng, res
        assert tiles() is None
    finally:
        gc.enable()


def test_run_validates_sources():
    src, dst = generate("chain", 20)
    eng = plan(shard_graph(src, dst, 20, 2), num_sources=2,
               device="cpu").compile()
    for bad, match in (([20], "outside"), ([1, 1], "duplicate"),
                       ([0, 1, 2], "capacity"), ([], "at least one"),
                       ([0.5], "integer")):
        with pytest.raises(ValueError, match=match):
            eng.run(bad)


def test_plan_rejects_what_this_slice_does_not_port():
    src, dst = generate("erdos_renyi", 128, seed=0, avg_degree=4)
    g = shard_graph(src, dst, 128, 1)
    for mode in ("queue", "auto"):
        with pytest.raises(ValueError, match="mode='dense'"):
            plan(g, BFSOptions(mode=mode, use_kernel=True), device="cpu")
    # auto plans with S > 1 since the sparse slice: no queue level, so no
    # sieve, and the run is the oracle's
    pl = plan(g, BFSOptions(mode="auto"), num_sources=2, device="cpu")
    assert not pl.sieve and pl.describe()["mode"] == "auto"
    np.testing.assert_array_equal(pl.compile().run([0, 5]).dist_host,
                                  bfs_reference(src, dst, 128, [0, 5]))
    with pytest.raises(ValueError, match="single source"):
        plan(g, BFSOptions(mode="queue"), num_sources=2, device="cpu")
    with pytest.raises(ValueError, match="1-D dense path"):
        plan(g, BFSOptions(use_kernel=True), partition="2d", device="cpu")
    # the 2-D partition plans since the grid slice; its grid validation
    pl2 = plan(g, partition="2d", device="cpu")
    assert pl2.describe()["grid"] == (1, 1)
    np.testing.assert_array_equal(pl2.compile().run([0]).dist_host,
                                  bfs_reference(src, dst, 128, [0]))
    g4 = shard_graph(src, dst, 128, 4)
    with pytest.raises(ValueError, match="2-axis mesh"):
        plan(g4, partition="2d", device="cpu")
    with pytest.raises(ValueError, match="does not multiply"):
        plan(g4, mesh=LocalMesh.grid(2, 1, "cpu"), partition="2d")
    with pytest.raises(ValueError, match="exactly two mesh axes"):
        plan(g4, mesh=LocalMesh.flat(4, "cpu"), partition="2d")
    with pytest.raises(ValueError, match="laid out for a 2x2 grid"):
        plan(to_2d(g4, 2, 2), mesh=LocalMesh.grid(4, 1, "cpu"))
    with pytest.raises(ValueError, match="needs a 1-D ShardedGraph"):
        plan(to_2d(g4, 2, 2), mesh=LocalMesh.flat(4, "cpu"), partition="1d")
    with pytest.raises(ValueError, match="packed wire"):
        plan(g, BFSOptions(use_fused_tail=True, wire_format="bytes"),
             device="cpu")
    with pytest.raises(ValueError, match="do not multiply"):
        plan(g, mesh=LocalMesh.flat(2, "cpu"))
    with pytest.raises(ValueError, match="differs"):
        plan(g, mesh=LocalMesh.flat(1, "cpu"), device="meta")
    with pytest.raises(ValueError, match="unknown dense exchange"):
        plan(g, BFSOptions(dense_exchange="nope"), device="cpu")
    with pytest.raises(ValueError, match="num_sources"):
        plan(g, num_sources=0, device="cpu")


def test_plan_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst = generate("chain", 10)
    g = shard_graph(src, dst, 10, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan(g)
    with pytest.raises(RuntimeError, match="no CUDA"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_validate_bfs_catches_each_rule(jax_runs):
    src, dst, n, srcs, _, want, _ = jax_runs["er"]
    validate_bfs(src, dst, srcs, want)
    reached = np.flatnonzero((want[:, 0] > 1) & (want[:, 0] < 2 ** 30))
    v = int(reached[0])
    cases = []
    d = want.copy(); d[v, 0] += 2; cases.append((d, "depths|in-neighbour"))
    d = want.copy(); d[v, 0] = 2 ** 30; cases.append((d, "depths"))
    d = want.copy(); d[srcs[1], 1] = 1; cases.append((d, "not at depth 0"))
    d = want.copy(); d[v, 2] = -3; cases.append((d, "neither INF"))
    d = want.copy(); d[v, 3] = 0; cases.append((d, "vertices at depth 0"))
    for bad, match in cases:
        with pytest.raises(ValueError, match=match):
            validate_bfs(src, dst, srcs, bad)
    # a vertex whose only claim to its depth is a neighbour at the same
    # depth: edges pass the |d(u) - d(v)| <= 1 rule, the parent rule fails
    s2, d2 = np.array([0, 1, 1, 2]), np.array([1, 0, 2, 1])
    with pytest.raises(ValueError, match="in-neighbour"):
        validate_bfs(s2, d2, [0], np.array([[0], [1], [1]]))
    np.testing.assert_array_equal(bfs_reference(src, dst, n, srcs),
                                  j_bfs_reference(src, dst, n, srcs))
