"""Elastic resharding of the port (``train.elastic``, ``core.partition``'s
``Partition`` and ``repartition``, ``core.frontier.frontier_nonzero``) on
the CPU against the JAX package's: ``repartition_graph``,
``repartition_vertex_array`` and ``repartition`` bitwise JAX's on seeded
graphs for p 4 -> 2, 4 -> 1 and 3 -> 5, a BFS after repartition equal to
``bfs_reference`` (as ``tests/test_train_substrate.py`` and
``tests/test_core_bfs.py`` hold JAX's); ``reshard_state`` keeping every
leaf's value in new tensors, and raising where JAX's ``reshard_state``
raises on 4 host devices (``helpers/elastic_jax.py``, a subprocess).
Everything compares exactly."""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as j_frontier
from repro.core.partition import Partition1D as JPartition1D
from repro.core.partition import repartition as j_repartition
from repro.graphs import generate as j_generate
from repro.graphs import shard_graph as j_shard_graph
from repro.train import elastic as j_elastic
from repro_torch.core import (BFSOptions, Partition, Partition1D,
                              Partition2D, plan, repartition)
from repro_torch.core.frontier import frontier_nonzero
from repro_torch.core.mesh import LocalMesh
from repro_torch.core.ref import bfs_reference
from repro_torch.graphs import shard_graph
from repro_torch.launch.shardings import P
from repro_torch.train import elastic

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

REPARTITIONS = [(4, 2), (4, 1), (3, 5)]
ARRAYS = ("src_local", "dst_global", "in_src_global", "in_dst_local")


def _graph(n: int, seed: int):
    return j_generate("erdos_renyi", n, seed=seed, avg_degree=6)


@pytest.mark.parametrize("old_p,new_p", REPARTITIONS)
def test_repartition_graph_matches_jax(old_p, new_p):
    n = 601
    src, dst = _graph(n, seed=old_p * 10 + new_p)
    want = j_elastic.repartition_graph(j_shard_graph(src, dst, n, old_p),
                                       new_p)
    got = elastic.repartition_graph(shard_graph(src, dst, n, old_p), new_p)
    assert got.p == want.p == new_p
    assert got.n_edges == want.n_edges == src.size
    assert (got.part.n_logical, got.part.p) == (want.part.n_logical,
                                                want.part.p)
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(got, k),
                                      np.asarray(getattr(want, k)))


@pytest.mark.parametrize("old_p,new_p", REPARTITIONS)
def test_bfs_after_repartition_matches_reference(old_p, new_p):
    """The repartitioned graph traverses to ``bfs_reference``'s depths,
    and its distances re-slice to the old partition's."""
    n = 600
    src, dst = _graph(n, seed=5)
    g_old = shard_graph(src, dst, n, old_p)
    g_new = elastic.repartition_graph(g_old, new_p)
    roots = [0, 7, 599]
    want = bfs_reference(src, dst, n, roots)
    runs = {}
    for g in (g_old, g_new):
        eng = plan(g, BFSOptions(mode="dense"), num_sources=len(roots),
                   mesh=LocalMesh.flat(g.p, "cpu"), device="cpu").compile()
        res = eng.run(roots)
        np.testing.assert_array_equal(res.dist_host, want)
        runs[g.p] = res.dist.cpu().numpy()
    moved = elastic.repartition_vertex_array(runs[old_p], g_old.part,
                                             g_new.part)
    np.testing.assert_array_equal(moved[:n], runs[new_p][:n])


@pytest.mark.parametrize("n,old_p,new_p", [(100, 8, 3), (601, 4, 2),
                                           (601, 4, 1), (601, 3, 5)])
def test_repartition_vertex_array_matches_jax(n, old_p, new_p):
    rng = np.random.default_rng(n + old_p)
    old_n = JPartition1D(n, old_p).n
    for x in (rng.standard_normal((old_n, 3)).astype(np.float32),
              rng.integers(0, 9, old_n).astype(np.int32)):
        want = j_elastic.repartition_vertex_array(
            x, JPartition1D(n, old_p), JPartition1D(n, new_p))
        got = elastic.repartition_vertex_array(
            x, Partition1D(n, old_p), Partition1D(n, new_p))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,p,new_p", [(1000, 7, 3), (5, 1, 4), (64, 8, 8)])
def test_repartition_and_the_protocol(n, p, new_p):
    got = repartition(Partition1D(n, p), new_p)
    want = j_repartition(JPartition1D(n, p), new_p)
    assert (got.n_logical, got.p, got.shard_size, got.n) == (
        want.n_logical, want.p, want.shard_size, want.n)
    assert isinstance(got, Partition)
    assert isinstance(Partition2D(n, 2, 3), Partition)
    assert not isinstance(object(), Partition)


def test_frontier_nonzero_matches_jax():
    rng = np.random.default_rng(3)
    for x in (np.zeros((4, 5), np.int32), rng.integers(0, 2, (4, 5)),
              np.eye(3, dtype=np.uint8)):
        got = frontier_nonzero(torch.from_numpy(np.asarray(x)))
        assert got.dim() == 0
        assert bool(got) == bool(j_frontier.frontier_nonzero(jnp.asarray(x)))


# ---------------------------------------------------------------------------
# reshard_state
# ---------------------------------------------------------------------------

def _port_state(res: dict) -> dict:
    """The helper's seeded state as tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in res["state"].items()}


@pytest.fixture(scope="module")
def jax_reshard(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic") / "jax.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable,
                          str(ROOT / "tests" / "helpers" / "elastic_jax.py"),
                          str(out)], env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    return pickle.loads(out.read_bytes())


def test_reshard_state_keeps_values_in_new_tensors(jax_reshard):
    """4 shards to 2: every leaf JAX's value bitwise, a new tensor on the
    new mesh's device; writing into the output leaves the input as it
    was."""
    state = _port_state(jax_reshard)
    before = {k: v.clone() for k, v in state.items()}
    new = LocalMesh((2,), ("x",), "cpu")
    specs = {k: P(*s) for k, s in jax_reshard["new_specs"].items()}
    out = elastic.reshard_state(state, new, specs)
    assert sorted(out) == sorted(state)
    for k, v in out.items():
        np.testing.assert_array_equal(v.numpy(), jax_reshard["ok"][k])
        assert v.device == new.device and v.dtype == state[k].dtype
        assert v.data_ptr() != state[k].data_ptr()
        v.add_(1)
        assert torch.equal(state[k], before[k])


def test_reshard_state_raises_where_jaxs_does(jax_reshard):
    """An indivisible dim, an unknown axis and a repeated axis: JAX's
    placement raises on each; the port's raises ``ValueError`` before it
    copies anything."""
    new = LocalMesh((2,), ("x",), "cpu")
    assert sorted(jax_reshard["raises"]) == ["indivisible", "repeated_axis",
                                             "unknown_axis"]
    for name, spec in jax_reshard["bad_specs"].items():
        assert jax_reshard["raises"][name] is not None, name
        leaf = (torch.zeros((7, 6)) if name == "indivisible"
                else _port_state(jax_reshard)["w"])
        with pytest.raises(ValueError):
            elastic.reshard_state({"w": leaf}, new, {"w": P(*spec)})


def test_reshard_state_checks_the_tree():
    new = LocalMesh((1, 4), ("data", "model"), "cpu")
    state = {"a": torch.ones(8), "b": [torch.ones(4, 2)]}
    with pytest.raises(ValueError):          # a leaf without its spec
        elastic.reshard_state(state, new, {"a": P("model")})
    out = elastic.reshard_state(state, new, {"a": P("model"),
                                             "b": [P(("data", "model"))]})
    assert torch.equal(out["b"][0], state["b"][0])
