"""The engine on a ``DistMesh`` (one shard per ``gloo`` rank, on the CPU)
against the same plan on a ``LocalMesh`` and against the JAX engine.

At p = 2 and 4 (1-D) and on a 1 x 2 and a 2 x 2 grid (2-D), on small
``erdos_renyi`` and ``rmat`` graphs, every rank's ``dist_host``,
``levels``, ``mode_counts``, ``comm_bytes``, ``overflowed`` and
``sieve_hits`` equal the ``LocalMesh`` engine's at the same p, bitwise:
dense on both wires under every dense strategy (and the hierarchical
exchange over a 2 x 2 mesh's two axes), queue at S = 1 with the sieve and
the compressed wire (one case escalates), auto at S = 1 and S = 8, and
``use_kernel``.  One case a partition is held to the JAX engine directly
(a subprocess under ``repro.launch.host_devices(4)``, as
``tests/helpers/multidev_bfs.py`` runs JAX).  A rank holds only its
shard: its ``(shard, S)`` dist, and ``resident`` bytes that sum over the
ranks to the stacked engine's.  The census of a ``DistMesh`` plan
(``collective_audit``) has the ``LocalMesh`` census's roles and received
bytes, within the host-read budget.  A rank that reports a wrong shard
index gives distances the reference rejects.

The ranks run as subprocesses with a hard deadline
(``tests/helpers/dist_torch.py``), one group a world size, started when
the module starts.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import collective_audit as ca
from repro_torch.core import BFSOptions, LocalMesh, plan
from repro_torch.core.ref import bfs_reference
from repro_torch.graphs import generate, shard_graph

from helpers.dist_torch import start_ranks, wait_ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
# n is never a multiple of 32 * p, so every run has padding vertices
GRAPHS = {
    "er": ("erdos_renyi", 301, {"avg_degree": 5.0}),
    "rmat": ("rmat", 301, {"edge_factor": 8}),
}
SOURCES = [0, 7, 50, 33, 120, 205, 299, 11]

# (graph, partition, mesh, S, BFSOptions fields); mesh "flat" is the
# p-shard row, "grid" the r x c grid (1 x 2 at p = 2, 2 x 2 at p = 4)
CASES = {
    **{f"dense_{st}_{wf}": ("er", "1d", "flat", 4, dict(
        mode="dense", dense_exchange=st, wire_format=wf))
       for st in ("allgather_merge", "alltoall_direct", "reduce_scatter",
                  "hierarchical")
       for wf in ("bytes", "packed")},
    "dense_hierarchical_grid_axes": ("rmat", "1d", "grid", 4, dict(
        mode="dense", dense_exchange="hierarchical", wire_format="packed")),
    "dense_default_rmat": ("rmat", "1d", "flat", 8, {}),
    "dense_kernel": ("er", "1d", "flat", 4, dict(use_kernel=True)),
    "queue_compressed_sieve": ("er", "1d", "flat", 1, dict(
        mode="queue", wire_format="compressed", sieve=True)),
    "queue_compressed_escalates": ("rmat", "1d", "flat", 1, dict(
        mode="queue", wire_format="compressed", queue_cap=4, sieve=True)),
    "queue_merge_ids": ("er", "1d", "flat", 1, dict(
        mode="queue", queue_exchange="allgather_merge", wire_format="bytes",
        sieve=True)),
    "auto_s1": ("rmat", "1d", "flat", 1, dict(mode="auto")),
    "auto_s8": ("rmat", "1d", "flat", 8, dict(mode="auto")),
    "auto_s1_bytes_cap4": ("er", "1d", "flat", 1, dict(
        mode="auto", wire_format="bytes", queue_cap=4)),
    "2d_dense": ("rmat", "2d", "grid", 8, {}),
    "2d_dense_bytes": ("er", "2d", "grid", 4, dict(wire_format="bytes")),
    "2d_queue_compressed_sieve": ("er", "2d", "grid", 1, dict(
        mode="queue", wire_format="compressed", sieve=True)),
    "2d_queue_escalates": ("rmat", "2d", "grid", 1, dict(
        mode="queue", queue_cap=4)),
    "2d_auto_s1": ("rmat", "2d", "grid", 1, dict(mode="auto")),
    "2d_auto_s8": ("rmat", "2d", "grid", 8, dict(mode="auto")),
}
# the cases audited on both meshes, and the ones held to JAX at p = 4
AUDITED = ("auto_s1", "2d_auto_s1", "dense_default_rmat")
JAX_CASES = ("auto_s1", "2d_queue_compressed_sieve")
FAULT_CASE = "dense_default_rmat"


def _graph(key):
    kind, n, kw = GRAPHS[key]
    src, dst = generate(kind, n, seed=2, **kw)
    return src, dst, n


def _grid(p):
    return (2, p // 2) if p == 4 else (1, p)


def _mesh(kind, p, dist_mesh):
    """The case's mesh: a ``DistMesh`` on this rank, else a
    ``LocalMesh`` on the CPU."""
    if dist_mesh:
        from repro_torch.core.dist_mesh import DistMesh

        return (DistMesh.grid(*_grid(p), "cpu") if kind == "grid"
                else DistMesh.flat("cpu"))
    return (LocalMesh.grid(*_grid(p), "cpu") if kind == "grid"
            else LocalMesh.flat(p, "cpu"))


def _plan(name, p, mesh):
    graph, part, _, s, fields = CASES[name]
    src, dst, n = _graph(graph)
    g = shard_graph(src, dst, n, p)
    axis = tuple(mesh.axis_names)
    return plan(g, BFSOptions(**fields), mesh=mesh, axis=axis,
                num_sources=s, partition=part), src, dst, n


def _summary(res) -> dict:
    return {"dist": res.dist_host.tolist(),
            "stats": res.run_stats.to_host()}


def _loop_census(rep) -> list:
    """The in-loop rows of a census: what must equal across meshes."""
    return [(op["kind"], op["role"], op["recv_bytes"], op["level"],
             op["level_kind"], op["group_size"])
            for op in rep.info["census"] if op["in_loop"]]


def _rank_cases():
    """Rank body: every case at this world size on a ``DistMesh``."""
    import torch.distributed as dist

    from repro_torch.core.dist_mesh import DistMesh

    p = dist.get_world_size()
    out = {}
    for name, (_, _, kind, s, _) in CASES.items():
        mesh = _mesh(kind, p, True)
        pl, *_ = _plan(name, p, mesh)
        eng = pl.compile()
        res = eng.run(SOURCES[:s])
        out[name] = _summary(res) | {
            "rows": list(eng._dist.shape),
            "terms": pl.device_byte_terms(),
            "describe_mesh": pl.describe()["mesh"],
            "roofline_link": pl.describe()["roofline"]["dense"]["link"]}
        if name in AUDITED:
            rep = ca.audit_engine(eng, sources=SOURCES[:s])
            out[name]["audit"] = {
                "ok": rep.ok(), "violations": [str(v) for v in
                                               rep.violations],
                "census": _loop_census(rep),
                "host_reads": rep.info["host_reads"]}

    class WrongIndex(DistMesh):
        """Rank 1 claims the shard after its own."""

        @property
        def local_shards(self):
            k = (self.rank + 1) % self.p if self.rank == 1 else self.rank
            return range(k, k + 1)

    pl, *_ = _plan(FAULT_CASE, p, WrongIndex((p,), ("bfs_p",), "cpu"))
    out["fault"] = _summary(pl.compile().run(SOURCES[:CASES[FAULT_CASE][3]]))
    # a plan keys apart from the LocalMesh plan of the same graph and p,
    # and a graph of another p does not plan on this group
    pl, src, dst, n = _plan(FAULT_CASE, p, DistMesh.flat("cpu"))
    out["keys_apart"] = pl.plan_key() != _plan(
        FAULT_CASE, p, LocalMesh.flat(p, "cpu"))[0].plan_key()
    try:
        plan(shard_graph(src, dst, n, p + 1), mesh=DistMesh.flat("cpu"))
        out["wrong_p"] = "no error"
    except ValueError as e:
        out["wrong_p"] = str(e)
    return out


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    """Start both worlds' ranks and the JAX subprocess at once; each is
    waited for on first use."""
    procs = {w: start_ranks(w, "test_torch_dist_engine:_rank_cases",
                            tmp_path_factory.mktemp(f"engine{w}"))
             for w in WORLDS}
    jax_out = tmp_path_factory.mktemp("dist_jax") / "runs.json"
    root = Path(__file__).resolve().parents[1]
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from repro.launch import host_devices; host_devices(4); "
            "import test_torch_dist_engine as t; t._jax_worker(sys.argv[3])")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", code, str(root / "src"), str(root / "tests"),
         str(jax_out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    done = {}

    def runs(world):
        if world not in done:
            done[world] = wait_ranks(procs[world], timeout=180)
        return done[world]

    def jax_runs():
        if "jax" not in done:
            try:
                _, err = jax_proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                jax_proc.kill()
                _, err = jax_proc.communicate()
            assert jax_proc.returncode == 0, err[-4000:]
            done["jax"] = json.loads(jax_out.read_text())
        return done["jax"]

    yield runs, jax_runs
    for p, _ in [x for ps in procs.values() for x in ps] + [(jax_proc, 0)]:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _jax_worker(path: str) -> None:
    """Subprocess body: the JAX engine on ``JAX_CASES`` at p = 4 (JAX
    already imported with four host devices by the caller)."""
    import jax
    from jax.sharding import Mesh

    from repro.core import BFSOptions as JOptions
    from repro.core import plan as jplan
    from repro.graphs import shard_graph as j_shard_graph

    out = {}
    for name in JAX_CASES:
        graph, part, kind, s, fields = CASES[name]
        src, dst, n = _graph(graph)
        devs = np.asarray(jax.devices()[:4])
        mesh = (Mesh(devs.reshape(2, 2), ("rows", "cols")) if kind == "grid"
                else Mesh(devs, ("bfs_p",)))
        pl = jplan(j_shard_graph(src, dst, n, 4), JOptions(**fields),
                   mesh=mesh, num_sources=s, partition=part)
        res = pl.compile().run(SOURCES[:s])
        out[name] = {"dist": res.dist_host.tolist(),
                     "stats": res.run_stats.to_host()}
    Path(path).write_text(json.dumps(out))


_LOCAL = {}


def _local(name, p):
    """The ``LocalMesh`` run of a case (cached: tests share it)."""
    if (name, p) not in _LOCAL:
        pl, src, dst, n = _plan(name, p, _mesh(CASES[name][2], p, False))
        eng = pl.compile()
        s = CASES[name][3]
        _LOCAL[(name, p)] = (pl, eng, _summary(eng.run(SOURCES[:s])),
                             bfs_reference(src, dst, n, SOURCES[:s]))
    return _LOCAL[(name, p)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_dist_engine_equals_local_mesh(dist_runs, world, name):
    runs, _ = dist_runs
    _, _, want, ref = _local(name, world)
    np.testing.assert_array_equal(np.asarray(want["dist"]), ref)
    for k, got in enumerate(runs(world)):
        np.testing.assert_array_equal(np.asarray(got[name]["dist"]), ref,
                                      err_msg=f"rank {k}")
        assert got[name]["stats"] == want["stats"], (k, name)


def test_matrix_reaches_every_level_kind(dist_runs):
    """The distributed runs take every level kind, escalate and sieve."""
    runs, _ = dist_runs
    stats = [runs(4)[0][name]["stats"] for name in CASES]
    for kind in ("dense", "queue", "bottom_up"):
        assert any(st["mode_counts"][kind] for st in stats), kind
    assert any(st["overflowed"] for st in stats)
    assert any(st["sieve_hits"] for st in stats)


@pytest.mark.parametrize("name", JAX_CASES)
def test_dist_engine_equals_jax(dist_runs, name):
    runs, jax_runs = dist_runs
    want = jax_runs()[name]
    for got in runs(4):
        np.testing.assert_array_equal(np.asarray(got[name]["dist"]),
                                      np.asarray(want["dist"]))
        assert got[name]["stats"] == want["stats"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["dense_default_rmat", "dense_kernel",
                                  "auto_s8", "2d_dense", "2d_auto_s8"])
def test_a_rank_holds_its_shard(dist_runs, world, name):
    """A rank's dist is ``(shard, S)``; its ``resident`` bytes (graph
    blocks, validity words, indices) sum over the ranks to the stacked
    engine's, and ``describe()`` reports the mesh and an NVLink price."""
    runs, _ = dist_runs
    pl, eng, _, _ = _local(name, world)
    shard, s = pl.graph.part.shard_size, pl.num_sources
    ranks = runs(world)
    for k, got in enumerate(ranks):
        assert got[name]["rows"] == [shard, s]
        assert got[name]["describe_mesh"]["kind"] == "DistMesh"
        assert got[name]["describe_mesh"]["rank"] == k
        assert got[name]["roofline_link"] == "nvlink"
    terms = pl.device_byte_terms()
    if not pl.opts.use_kernel:          # the row pointer's end is per rank
        assert sum(r[name]["terms"]["resident"] for r in ranks) == \
            terms["resident"]
    assert sum(r[name]["terms"]["work"] for r in ranks) == terms["work"]
    assert pl.describe()["roofline"]["dense"]["link"] == "hbm"


@pytest.mark.parametrize("name", AUDITED)
def test_dist_census_equals_local_census(dist_runs, name):
    """Every rank's census of its own collectives has the ``LocalMesh``
    census's roles, kinds, groups and received bytes, level by level; the
    audit is clean and the host reads stay within the budget."""
    runs, _ = dist_runs
    pl, eng, _, _ = _local(name, 4)
    s = CASES[name][3]
    rep = ca.audit_engine(eng, sources=SOURCES[:s])
    assert rep.ok(), [str(v) for v in rep.violations]
    want = [tuple(row) for row in _loop_census(rep)]
    assert any(row[1] == "control" for row in want)
    for got in runs(4):
        audit = got[name]["audit"]
        assert audit["ok"], audit["violations"]
        assert [tuple(row) for row in audit["census"]] == want
        reads = audit["host_reads"]
        assert reads["counted_by"] == "host_read"
        for kind, n in reads["max_per_level"].items():
            assert n <= ca.HOST_READ_BUDGET[kind]


@pytest.mark.parametrize("world", WORLDS)
def test_plans_key_apart_and_a_wrong_p_raises(dist_runs, world):
    runs, _ = dist_runs
    for got in runs(world):
        assert got["keys_apart"]
        assert f"multiply to the graph's p={world + 1}" in got["wrong_p"]


@pytest.mark.parametrize("world", WORLDS)
def test_a_wrong_shard_index_fails_the_check(dist_runs, world):
    runs, _ = dist_runs
    ref = _local(FAULT_CASE, world)[3]
    got = runs(world)[1]["fault"]
    assert not np.array_equal(np.asarray(got["dist"]), ref)
