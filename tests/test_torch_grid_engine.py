"""The port's 2-D edge partition (``partition="2d"``) against the JAX 2-D
engine in the dense, queue and ``auto`` modes: dist bitwise, and levels,
comm_bytes, overflowed, mode_counts, sieve_hits and the 2-D
``describe()`` keys (bar the TPU roofline) equal, over graphs, wire
formats, phase strategies, sieve settings, queue capacities (4 forces the
dense escalation, and with the compressed wire a truncated frontier
stream) and S up to 64; every run also equals the serial oracle and the
port's ``bfs_reference_2d`` schedule.

The 1 x 1 grid runs the JAX engine in this process.  The 2 x 2, 4 x 1
and 1 x 4 grids need four JAX devices, which XLA fixes when JAX is first
imported, so one subprocess (``_jax_worker``, started before the 1 x 1
tests run) forces four host devices before its JAX import, as
``tests/test_torch_sparse_engine.py`` does, and writes the JAX runs of
every case to a JSON file.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import BFSOptions, LocalMesh, plan
from repro_torch.core.ref import bfs_reference, bfs_reference_2d
from repro_torch.graphs import from_jax_arrays_2d, generate, shard_graph

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
SOURCES = [0, 7, 50, 33]     # then the other ids in order, up to S = 64

# (graph, S, BFSOptions fields): every mode, wire format, phase strategy,
# sieve setting and the escalating queue_cap of the matrix appears
CASES = {
    "dense_default": ("rmat", 4, dict(mode="dense")),
    "dense_bytes": ("er", 4, dict(mode="dense", wire_format="bytes")),
    "dense_packed_unfused": ("er", 4, dict(mode="dense", wire_format="packed",
                                           use_fused_tail=False)),
    "dense_s64_reduce_scatter": ("er", 64, dict(
        mode="dense", wire_format="bytes", fold_exchange="reduce_scatter")),
    "dense_s1_reduce_scatter_packed": ("rmat", 1, dict(
        mode="dense", wire_format="packed", fold_exchange="reduce_scatter")),
    "queue_bytes_nosieve": ("er", 1, dict(mode="queue", wire_format="bytes",
                                          sieve=False)),
    "queue_compressed_sieve": ("er", 1, dict(mode="queue",
                                             wire_format="compressed",
                                             sieve=True)),
    "queue_cap4_escalates": ("star", 1, dict(mode="queue", queue_cap=4)),
    "queue_merge_plain": ("chain", 1, dict(
        mode="queue", wire_format="packed",
        fold_sparse_exchange="allgather_merge", local_update=False,
        dedupe=False)),
    "queue_compressed_merge_cap4": ("rmat", 1, dict(
        mode="queue", wire_format="compressed",
        fold_sparse_exchange="allgather_merge", queue_cap=4, sieve=False)),
    "queue_compressed_cap4_sieve_fused": ("rmat", 1, dict(
        mode="queue", wire_format="compressed", queue_cap=4, sieve=True,
        use_fused_tail=True)),
    "auto_default": ("rmat", 1, dict(mode="auto")),
    "auto_s4_default": ("rmat", 4, dict(mode="auto")),
    "auto_s4_bytes": ("er", 4, dict(mode="auto", wire_format="bytes")),
    "auto_compressed_cap4": ("chain", 1, dict(mode="auto",
                                              wire_format="compressed",
                                              queue_cap=4)),
    "auto_packed_sieve_unfused": ("rmat", 1, dict(
        mode="auto", wire_format="packed", sieve=True, queue_cap=4,
        use_fused_tail=False)),
    "auto_nosieve_star": ("star", 1, dict(mode="auto", sieve=False)),
    "auto_s64": ("rmat", 64, dict(mode="auto")),
}
# every case on the square grid; the degenerate grids (no fold phase on
# 1 x 4, no expand phase on 4 x 1) on the cases that resolve their wires
# and fused tail differently there
DEGENERATE = ("dense_default", "dense_bytes", "queue_compressed_sieve",
              "queue_cap4_escalates", "auto_default", "auto_s4_default",
              "auto_compressed_cap4")
GRID_CASES = ([(name, (2, 2)) for name in CASES]
              + [(name, grid) for grid in ((4, 1), (1, 4))
                 for name in DEGENERATE])


def _edges(key):
    kind, n, kw = GRAPHS[key]
    src, dst = generate(kind, n, seed=2, **kw)
    return src, dst, n, list(dict.fromkeys([v % n for v in SOURCES]
                                           + list(range(n))))


def _jsonable(x):
    return json.loads(json.dumps(x))


def _jax_runs(cases, mesh_for) -> dict:
    """The JAX 2-D engine's run of every ``(case, grid)``: dist as lists,
    run stats and ``describe()`` without its TPU roofline."""
    from repro.core import BFSOptions as JOptions
    from repro.core import plan as jplan
    from repro.graphs import shard_graph as j_shard_graph

    out = {}
    for name, (r, c) in cases:
        graph, s, fields = CASES[name]
        src, dst, n, srcs = _edges(graph)
        pl = jplan(j_shard_graph(src, dst, n, r * c), JOptions(**fields),
                   num_sources=s, partition="2d", **mesh_for(r, c))
        res = pl.compile().run(srcs[:s])
        desc = pl.describe()
        desc.pop("roofline", None)
        out[f"{name}/{r}x{c}"] = {"dist": res.dist_host.tolist(),
                                  "stats": res.run_stats.to_host(),
                                  "describe": _jsonable(desc)}
    return out


def _jax_worker(path: str) -> None:
    """Subprocess body: the JAX runs on the 4-cell grids (JAX already
    imported with four host devices by the caller)."""
    from repro.launch.mesh import make_grid_mesh

    def mesh_for(r, c):
        return {"mesh": make_grid_mesh(r, c)}

    Path(path).write_text(json.dumps(_jax_runs(GRID_CASES, mesh_for)))


@pytest.fixture(scope="module", autouse=True)
def grid_jax(tmp_path_factory):
    """Start the JAX subprocess first, so it runs beside the 1 x 1 tests;
    yields a function that waits for it and returns its runs."""
    out = tmp_path_factory.mktemp("grid_jax") / "runs.json"
    root = Path(__file__).resolve().parents[1]
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from repro.launch import host_devices; host_devices(4); "
            "import test_torch_grid_engine as t; t._jax_worker(sys.argv[3])")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", code, str(root / "src"), str(root / "tests"),
         str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    cache = {}

    def runs():
        if not cache:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            cache.update(json.loads(out.read_text()))
        return cache

    yield runs
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def single_cell_jax():
    return _jax_runs([(name, (1, 1)) for name in CASES], lambda r, c: {})


def _check_case(name, grid, want):
    graph, s, fields = CASES[name]
    src, dst, n, srcs = _edges(graph)
    r, c = grid
    opts = BFSOptions(**fields)
    pl = plan(shard_graph(src, dst, n, r * c), opts, num_sources=s,
              mesh=LocalMesh.grid(r, c, "cpu"), partition="2d")
    res = pl.compile().run(srcs[:s])
    stats = res.run_stats.to_host()
    np.testing.assert_array_equal(res.dist_host,
                                  bfs_reference(src, dst, n, srcs[:s]))
    np.testing.assert_array_equal(res.dist_host, np.asarray(want["dist"]))
    assert stats == want["stats"]
    desc = _jsonable(pl.describe())
    assert set(want["describe"]) <= set(desc)
    for k, v in want["describe"].items():
        assert desc[k] == v, k
    # the host simulation's schedule; it models neither the sieve nor the
    # codec, so its overflow flags are held only where neither can act
    dist2, sched = bfs_reference_2d(
        src, dst, n, srcs[:s], r, c, mode=opts.mode, queue_cap=opts.queue_cap,
        local_update=opts.local_update, dedupe=opts.dedupe,
        return_schedule=True)
    np.testing.assert_array_equal(dist2, res.dist_host)
    kinds = [lv["kind"] for lv in sched]
    assert len(kinds) == stats["levels"]
    assert {k: kinds.count(k) for k in ("dense", "queue", "bottom_up")} == \
        stats["mode_counts"]
    if not desc["sieve"] and desc["wire_formats"]["expand_sparse"] == "ids" \
            and desc["wire_formats"]["fold_sparse"] == "ids":
        assert any(lv["overflowed"] for lv in sched) == stats["overflowed"]
    return stats


@pytest.mark.parametrize("name", list(CASES))
def test_grid_engine_matches_jax_single_cell(single_cell_jax, name):
    _check_case(name, (1, 1), single_cell_jax[f"{name}/1x1"])


@pytest.mark.parametrize("name,grid", GRID_CASES,
                         ids=[f"{n}-{g[0]}x{g[1]}" for n, g in GRID_CASES])
def test_grid_engine_matches_jax_on_four_cells(grid_jax, name, grid):
    stats = _check_case(name, grid, grid_jax()[f"{name}/{grid[0]}x{grid[1]}"])
    if name == "queue_cap4_escalates":
        assert stats["overflowed"] and stats["mode_counts"]["queue"] > 0
    if name == "queue_compressed_sieve":
        assert stats["sieve_hits"] > 0


def test_grid_matrix_reaches_every_level_kind_and_wire(grid_jax):
    """The JAX runs the port is held to take every level kind, escalate,
    sieve, and resolve every wire: the matrix is not vacuous."""
    runs = grid_jax().values()
    stats = [r["stats"] for r in runs]
    for kind in ("dense", "queue", "bottom_up"):
        assert any(st["mode_counts"][kind] for st in stats), kind
    assert any(st["overflowed"] for st in stats)
    assert any(st["sieve_hits"] for st in stats)
    wires = {(k, r["describe"]["wire_formats"][k]) for r in runs
             for k in ("expand", "fold", "expand_sparse", "fold_sparse")}
    assert wires == {("expand", "bytes"), ("expand", "packed"),
                     ("fold", "bytes"), ("fold", "packed"),
                     ("expand_sparse", "ids"),
                     ("expand_sparse", "compressed"),
                     ("fold_sparse", "ids"), ("fold_sparse", "compressed")}
    fused = {r["describe"]["use_fused_tail"] for r in runs}
    assert fused == {True, False}


def test_degenerate_grids_resolve_wires_as_jax(grid_jax):
    """Default options on 2 x 2, 4 x 1 and 1 x 4: the fold is free on
    1 x 4 (its packed twin is not cheaper, so bytes and no fused tail),
    the expand is free on 4 x 1."""
    runs = grid_jax()
    got = {g: (runs[f"dense_default/{g}"]["describe"]["wire_formats"],
               runs[f"dense_default/{g}"]["describe"]["use_fused_tail"])
           for g in ("2x2", "4x1", "1x4")}
    assert got["2x2"][0]["expand"] == "packed" and got["2x2"][1]
    assert got["4x1"][0]["expand"] == "bytes" and got["4x1"][1]
    assert got["1x4"][0]["fold"] == "bytes" and not got["1x4"][1]


def test_a_jax_grid_carries_over(single_cell_jax):
    """A ShardedGraph2D carried over from the JAX package plans (the
    partition inferred) the same traversal; the engine reruns with other
    sources bitwise."""
    from repro.graphs import shard_graph_2d as j_shard_graph_2d

    src, dst, n, srcs = _edges("rmat")
    g2 = from_jax_arrays_2d(j_shard_graph_2d(src, dst, n, 1, 1))
    pl = plan(g2, BFSOptions(mode="auto"), num_sources=1, device="cpu")
    assert pl.partition == "2d" and pl.graph2d is g2
    eng = pl.compile()
    first = eng.run([srcs[0]]).dist_host
    np.testing.assert_array_equal(
        first, np.asarray(single_cell_jax["auto_default/1x1"]["dist"]))
    for v in srcs[1:6]:
        np.testing.assert_array_equal(eng.run([v]).dist_host,
                                      bfs_reference(src, dst, n, [v]))
    np.testing.assert_array_equal(eng.run([srcs[0]]).dist_host, first)


def test_queue_level_past_its_width_recounts_hits_or_raises(grid_jax,
                                                            monkeypatch):
    """A queue level packs each cell's active edges into the width its
    statistics bound.  A truncated compressed frontier can decode to a
    vertex outside the frontier and so to more active edges; its codec
    overflow escalates the level, and the sieve's hits are then counted
    over every active edge, as JAX counts them.  Forced here with a width
    of 1 on the levels whose frontier overflows a chunk's ``queue_cap``
    ids (those escalate): on the star with ``queue_cap=4`` the stats stay
    JAX's.  Past the width on a level that does not escalate is a fault,
    and raises."""
    from repro_torch.core import bfs

    real = bfs._level_runner
    narrow_all = False

    def narrow(part, s, mode, e_total, opts, mesh, dense, queue, bottom_up,
               stats, fused, vwords):
        def narrowed(f):
            f_verts, f_edges, width = stats(f)
            chunk_max = int((f[..., 0] > 0).sum(1).max())
            if narrow_all or chunk_max > opts.queue_cap:
                width = 1
            return f_verts, f_edges, width

        return real(part, s, mode, e_total, opts, mesh, dense, queue,
                    bottom_up, narrowed, fused, vwords)

    monkeypatch.setattr(bfs, "_level_runner", narrow)
    stats = _check_case("queue_cap4_escalates", (2, 2),
                        grid_jax()["queue_cap4_escalates/2x2"])
    assert stats["sieve_hits"] > 0
    narrow_all = True
    with pytest.raises(RuntimeError, match="width"):
        _check_case("queue_bytes_nosieve", (2, 2),
                    grid_jax()["queue_bytes_nosieve/2x2"])
