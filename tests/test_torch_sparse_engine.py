"""The port's queue and direction-optimizing ``auto`` modes (1-D partition)
against the JAX engine: dist bitwise, and levels, comm_bytes, overflowed,
mode_counts, sieve_hits and the shared ``describe()`` keys equal, over
graphs, wire formats, sieve settings, queue capacities (4 forces the
dense escalation) and S (up to 64, the S of the card's paths, which the
dense mode also runs here).

p = 1 runs the JAX engine in this process.  p = 2 and 4 need as many
JAX devices, which XLA fixes when JAX is first imported, so one
subprocess per module (``_jax_worker`` below, started before the p = 1
tests run) forces four host devices before its JAX import, as
``tests/helpers/multidev_bfs.py`` does, and writes the JAX runs of every
case to a JSON file.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import BFSOptions, plan
from repro_torch.core.ref import bfs_reference
from repro_torch.graphs import from_jax_arrays, generate, shard_graph

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

# (graph, S, BFSOptions fields): every mode x wire_format x sieve setting
# x queue_cap of the matrix appears, auto with S = 1, 4 and 64
CASES = {
    "queue_bytes_nosieve": ("er", 1, dict(mode="queue", wire_format="bytes",
                                          sieve=False)),
    "queue_compressed_sieve": ("er", 1, dict(mode="queue",
                                             wire_format="compressed",
                                             sieve=True)),
    "queue_cap4_escalates": ("star", 1, dict(mode="queue", queue_cap=4)),
    "queue_packed_merge_plain": ("chain", 1, dict(
        mode="queue", wire_format="packed", queue_exchange="allgather_merge",
        local_update=False, dedupe=False)),
    "queue_compressed_merge_cap4": ("rmat", 1, dict(
        mode="queue", wire_format="compressed",
        queue_exchange="allgather_merge", queue_cap=4, sieve=False)),
    "auto_default": ("rmat", 1, dict(mode="auto")),
    "auto_s4_default": ("rmat", 4, dict(mode="auto")),
    "auto_s4_bytes": ("er", 4, dict(mode="auto", wire_format="bytes")),
    "auto_compressed_cap4": ("chain", 1, dict(mode="auto",
                                              wire_format="compressed",
                                              queue_cap=4)),
    "auto_packed_sieve_unfused": ("rmat", 1, dict(
        mode="auto", wire_format="packed", sieve=True, queue_cap=4,
        use_fused_tail=False)),
    "auto_s4_packed_star": ("star", 4, dict(mode="auto",
                                            wire_format="packed")),
    "auto_nosieve": ("er", 1, dict(mode="auto", sieve=False)),
    "auto_s64": ("rmat", 64, dict(mode="auto")),
    "dense_s64": ("er", 64, dict(mode="dense")),
}
MULTI_P = (2, 4)


def _edges(key):
    kind, n, kw = GRAPHS[key]
    src, dst = generate(kind, n, seed=2, **kw)
    return src, dst, n, list(dict.fromkeys([v % n for v in SOURCES]
                                           + list(range(n))))


def _jsonable(x):
    return json.loads(json.dumps(x))


def _jax_runs(ps, mesh_for) -> dict:
    """The JAX engine's run of every case at every p in ``ps``: dist as
    lists, run stats and ``describe()`` without its TPU roofline."""
    from repro.core import BFSOptions as JOptions
    from repro.core import plan as jplan
    from repro.graphs import shard_graph as j_shard_graph

    out = {}
    for name, (graph, s, fields) in CASES.items():
        src, dst, n, srcs = _edges(graph)
        for p in ps:
            pl = jplan(j_shard_graph(src, dst, n, p), JOptions(**fields),
                       num_sources=s, **mesh_for(p))
            res = pl.compile().run(srcs[:s])
            desc = pl.describe()
            desc.pop("roofline", None)
            out[f"{name}/{p}"] = {"dist": res.dist_host.tolist(),
                                  "stats": res.run_stats.to_host(),
                                  "describe": _jsonable(desc)}
    return out


def _jax_worker(path: str) -> None:
    """Subprocess body: the multi-shard JAX runs (JAX already imported
    with four host devices by the caller)."""
    import jax
    from jax.sharding import Mesh

    def mesh_for(p):
        return {"mesh": Mesh(np.asarray(jax.devices()[:p]), ("bfs_p",))}

    Path(path).write_text(json.dumps(_jax_runs(MULTI_P, mesh_for)))


@pytest.fixture(scope="module", autouse=True)
def multi_shard_jax(tmp_path_factory):
    """Start the JAX subprocess first, so it runs beside the p = 1 tests;
    yields a function that waits for it and returns its runs."""
    out = tmp_path_factory.mktemp("sparse_jax") / "runs.json"
    root = Path(__file__).resolve().parents[1]
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from repro.launch import host_devices; host_devices(4); "
            "import test_torch_sparse_engine as t; t._jax_worker(sys.argv[3])")
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
def single_shard_jax():
    return _jax_runs((1,), lambda p: {})


def _check_case(name, p, want):
    graph, s, fields = CASES[name]
    src, dst, n, srcs = _edges(graph)
    g = shard_graph(src, dst, n, p)
    pl = plan(g, BFSOptions(**fields), num_sources=s, device="cpu")
    res = pl.compile().run(srcs[:s])
    np.testing.assert_array_equal(res.dist_host,
                                  bfs_reference(src, dst, n, srcs[:s]))
    np.testing.assert_array_equal(res.dist_host, np.asarray(want["dist"]))
    assert res.run_stats.to_host() == want["stats"]
    desc = _jsonable(pl.describe())
    assert set(want["describe"]) <= set(desc)
    for k, v in want["describe"].items():
        assert desc[k] == v, k
    return res.run_stats.to_host()


@pytest.mark.parametrize("name", list(CASES))
def test_sparse_engine_matches_jax_single_shard(single_shard_jax, name):
    _check_case(name, 1, single_shard_jax[f"{name}/1"])


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("p", MULTI_P)
def test_sparse_engine_matches_jax_multi_shard(multi_shard_jax, name, p):
    stats = _check_case(name, p, multi_shard_jax()[f"{name}/{p}"])
    if name == "queue_cap4_escalates":
        assert stats["overflowed"] and stats["mode_counts"]["queue"] > 0
    if name == "queue_compressed_sieve":
        assert stats["sieve_hits"] > 0


def test_matrix_reaches_every_level_kind(multi_shard_jax):
    """The JAX runs the port is held to take every level kind, escalate,
    and sieve: the matrix is not vacuous."""
    stats = [r["stats"] for r in multi_shard_jax().values()]
    for kind in ("dense", "queue", "bottom_up"):
        assert any(st["mode_counts"][kind] for st in stats), kind
    assert any(st["overflowed"] for st in stats)
    assert any(st["sieve_hits"] for st in stats)
    wires = {r["describe"]["wire_formats"]["queue"]
             for r in multi_shard_jax().values()}
    assert wires == {"ids", "compressed"}


def test_auto_sources_carry_over_from_a_jax_graph(single_shard_jax):
    """A graph carried over from the JAX package plans the same auto
    traversal; the engine reruns with other sources bitwise."""
    from repro.graphs import shard_graph as j_shard_graph

    src, dst, n, srcs = _edges("rmat")
    eng = plan(from_jax_arrays(j_shard_graph(src, dst, n, 1)),
               BFSOptions(mode="auto"), num_sources=1,
               device="cpu").compile()
    first = eng.run([srcs[0]]).dist_host
    np.testing.assert_array_equal(
        first, np.asarray(single_shard_jax["auto_default/1"]["dist"]))
    for v in srcs[1:]:
        np.testing.assert_array_equal(eng.run([v]).dist_host,
                                      bfs_reference(src, dst, n, [v]))
    np.testing.assert_array_equal(eng.run([srcs[0]]).dist_host, first)
