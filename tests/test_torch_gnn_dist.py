"""Owner-exchange GraphCast (``models.gnn.dist_graphcast``) on the CPU
against the JAX package's global model: ``build_routing`` bitwise JAX's
with every edge routed once, the loss and every gradient leaf on a
``LocalMesh`` of 1, 4 and 8 shards and over 4 ``gloo`` ranks of a
``DistMesh`` (``helpers/gnn_dist_rank.py``), the differentiable
collectives of ``DistMesh`` against autograd through ``LocalMesh``, and
the planted fault of ``chip_smoke.py`` path 13 (one shard's
``serve_ids`` rolled by a row).

The limits are JAX's own for this comparison
(``tests/helpers/owner_gnn.py``): the loss within ``rtol=2e-5,
atol=2e-5``, each gradient within ``rtol=5e-4, atol=5e-5`` (JAX holds
two leaves; here every leaf is held).  A rank that summed the parameter
gradients twice, or a ``psum`` whose backward summed the cotangents,
would read p times the global gradient and fail them.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as JGNNConfig
from repro.graphs.generators import erdos_renyi as j_erdos_renyi
from repro.models.gnn import dist_graphcast as j_dg
from repro.models.gnn import models as j_models
from repro_torch import tree as tr
from repro_torch.configs import GNNConfig
from repro_torch.core.mesh import LocalMesh
from repro_torch.graphs import erdos_renyi
from repro_torch.launch.steps import autograd_grads
from repro_torch.models.convert import gnn_from_jax_params
from repro_torch.models.gnn import dist_graphcast as dg

from helpers.dist_torch import start_ranks, wait_ranks
from helpers.gnn_dist_rank import owner_batch

torch.set_num_threads(1)

N, D_FEAT, DIST_WORLD = 512, 16, 4
CFG = dict(name="gc-test", kind="graphcast", n_layers=3, d_hidden=32,
           aggregator="sum", n_vars=5, d_out=5)
LOSS_TOL = {"rtol": 2e-5, "atol": 2e-5}
GRAD_TOL = {"rtol": 5e-4, "atol": 5e-5}


def _problem() -> dict:
    """JAX's owner_gnn.py problem: an Erdős–Rényi graph of 512 nodes,
    normal features and targets, JAX's weights from key 1."""
    src, dst = erdos_renyi(N, avg_degree=6, seed=3)
    rng = np.random.default_rng(0)
    params = j_models.init_params(JGNNConfig(**CFG), D_FEAT,
                                  jax.random.PRNGKey(1))
    return {"src": src, "dst": dst, "n": N, "cfg": CFG,
            "feats": rng.standard_normal((N, D_FEAT)).astype(np.float32),
            "targets": rng.standard_normal((N, 5)).astype(np.float32),
            "params": jax.tree.map(np.asarray, params)}


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """The problem, JAX's global loss and gradients, and the gloo ranks
    (started here, waited for on first use)."""
    prob = _problem()
    e_pad = -(-prob["src"].shape[0] // 64) * 64
    es = np.zeros(e_pad, np.int32)
    ed = np.full(e_pad, -1, np.int32)
    es[:prob["src"].shape[0]] = prob["src"]
    ed[:prob["dst"].shape[0]] = prob["dst"]
    ref_batch = {
        "node_feats": jnp.asarray(prob["feats"]),
        "edge_src": jnp.asarray(es), "edge_dst": jnp.asarray(ed),
        "edge_feats": jnp.ones((e_pad, 4), jnp.float32),
        "valid_nodes": jnp.ones((N,), bool),
        "targets": jnp.asarray(prob["targets"]),
    }
    j_params = jax.tree.map(jnp.asarray, prob["params"])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_models.loss_fn(JGNNConfig(**CFG), p, b)[0]))(
            j_params, ref_batch)
    tmp = tmp_path_factory.mktemp("gnn_dist")
    (tmp / "problem.pkl").write_bytes(pickle.dumps(prob))
    procs = start_ranks(DIST_WORLD, "helpers.gnn_dist_rank:owner_exchange",
                        tmp, env_extra={"GNN_DIST_DIR": str(tmp)})
    done = {}

    def ranks():
        if "r" not in done:
            done["r"] = wait_ranks(procs, timeout=150)
        return done["r"]

    yield {"prob": prob, "loss": float(loss),
           "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
           "ranks": ranks, "tmp": tmp}
    for proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _owner_grads(prob, p: int, batch=None):
    mesh = LocalMesh.flat(p, "cpu", "p")
    params = gnn_from_jax_params(prob["params"], "cpu")
    loss_fn = dg.make_loss_fn(GNNConfig(**CFG), mesh, "p")
    grads, (loss, _) = autograd_grads(loss_fn)(
        params, batch if batch is not None else owner_batch(prob, p))
    return float(loss), [g.numpy() for g in grads], params


def _held(loss, grads, problem) -> bool:
    ok = np.isclose(loss, problem["loss"], **LOSS_TOL)
    return bool(ok and all(np.allclose(g, w, **GRAD_TOL)
                           for g, w in zip(grads, problem["grads"])))


# ----------------------------------------------------------------- routing

@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("graph", ["er", "skewed"])
def test_build_routing_is_bitwise_jax_and_routes_each_edge_once(p, graph):
    if graph == "er":
        src, dst = erdos_renyi(300, avg_degree=5, seed=p)
        j_src, j_dst = j_erdos_renyi(300, avg_degree=5, seed=p)
        np.testing.assert_array_equal(src, j_src)
        n = 300
    else:                   # every edge into the first shard, from all
        rng = np.random.default_rng(p)
        n = 203
        src = rng.integers(0, n, 900)
        dst = rng.integers(0, -(-n // p), 900)
    got = dg.build_routing(src, dst, n, p)
    want = j_dg.build_routing(src, dst, n, p)
    for k in ("serve_ids", "src_slot", "dst_local"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["r_cap"], got["e_cap"]) == (want["r_cap"], want["e_cap"])
    part, r_cap = got["part"], got["r_cap"]
    routed = []
    for j in range(p):
        for k in np.flatnonzero(got["dst_local"][j] >= 0):
            o, slot = divmod(int(got["src_slot"][j, k]), r_cap)
            routed.append((o * part.shard_size
                           + int(got["serve_ids"][o, j, slot]),
                           j * part.shard_size + int(got["dst_local"][j, k])))
    assert sorted(routed) == sorted(zip(src.tolist(), dst.tolist()))
    with pytest.raises(ValueError, match="r_cap"):
        dg.build_routing(src, dst, n, p, r_cap=1)


def test_exchange_bytes_is_the_module_s_claim():
    src, dst = erdos_renyi(N, avg_degree=6, seed=3)
    r = dg.build_routing(src, dst, N, 8)
    got = dg.exchange_bytes(r, 512)
    assert got == {"exchange": 8 * r["r_cap"] * 512 * 4,
                   "global_gathers": 2 * 512 * 512 * 4}


# ------------------------------------------------------------- LocalMesh

@pytest.mark.parametrize("p", [1, 4, 8])
def test_local_mesh_loss_and_every_gradient_equal_the_global_model(problem,
                                                                   p):
    loss, grads, params = _owner_grads(problem["prob"], p)
    np.testing.assert_allclose(loss, problem["loss"], **LOSS_TOL)
    paths = [tr.key_of(q) for q, _ in tr.leaves_with_paths(params)]
    assert len(grads) == len(problem["grads"]) == len(paths)
    for path, g, w in zip(paths, grads, problem["grads"]):
        np.testing.assert_allclose(g, w, err_msg=path, **GRAD_TOL)


def test_local_batch_takes_each_mesh_s_shards(problem):
    batch = owner_batch(problem["prob"], 4)
    loc = dg.local_batch(batch, LocalMesh.flat(4, "cpu", "p"))
    assert sorted(loc) == sorted(dg.BATCH_KEYS)
    assert loc["node_feats"].shape == (4, 128, D_FEAT)
    assert loc["serve_ids"].shape == (4, 1, 4, batch["serve_ids"].shape[2])
    assert torch.equal(loc["targets"][2], batch["targets"][256:384])


def test_rolled_serve_ids_fail_the_hold(problem):
    """chip_smoke.py path 13 (d)'s planted fault: shard 1's serve_ids
    rolled by one row (each row it serves a peer lands in the next
    slot)."""
    batch = owner_batch(problem["prob"], 4)
    batch["serve_ids"][1] = torch.roll(batch["serve_ids"][1], 1, dims=1)
    loss, grads, _ = _owner_grads(problem["prob"], 4, batch)
    assert not _held(loss, grads, problem)
    assert _held(*_owner_grads(problem["prob"], 4)[:2], problem)


# --------------------------------------------------------------- DistMesh

def test_dist_mesh_loss_and_every_gradient_equal_the_global_model(problem):
    """4 gloo ranks, a shard each: every rank's loss and every gradient
    leaf (summed over the ranks once, in ``replicate``'s backward) equal
    the global model's."""
    ranks = problem["ranks"]()
    assert [r["local_shards"] for r in ranks] == [[k] for k in
                                                  range(DIST_WORLD)]
    for k, r in enumerate(ranks):
        np.testing.assert_allclose(r["loss"], problem["loss"], **LOSS_TOL)
        got = np.load(problem["tmp"] / f"grads{k}.npz")
        grads = [got[f"arr_{i}"] for i in range(r["n_leaves"])]
        assert len(grads) == len(problem["grads"])
        for path, g, w in zip(r["paths"], grads, problem["grads"]):
            np.testing.assert_allclose(g, w, err_msg=f"rank {k} {path}",
                                       **GRAD_TOL)


@pytest.mark.parametrize("op", ["all_to_all", "psum", "replicate"])
def test_dist_mesh_collective_gradients_equal_local_mesh_s(problem, op):
    """Each rank's gradient through the differentiable collective equals
    its row of autograd through the ``LocalMesh`` of all four shards."""
    for k, r in enumerate(problem["ranks"]()):
        assert r["collectives"][op], (k, op)
