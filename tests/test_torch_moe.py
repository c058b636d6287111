"""The port's MoE layer (``models.moe``) on the CPU against the JAX
package's ``repro.models.moe``, f32: ``capacity``, the init's shapes, the
local route (drops, a zero router's ties, a shared expert, gradients), the
expert-parallel route on ``LocalMesh`` (1, 4) and (2, 2) against JAX's
under ``sharding_hints.hints`` on 4 host devices (a subprocess,
``helpers/moe_sharded_jax.py``) with JAX's fallbacks to the local route,
and ``DistMesh`` over 4 ``gloo`` ranks (``helpers/moe_dist_rank.py``)
against ``LocalMesh``.

Every case with a random router first asserts that each token's k-th and
(k+1)-th probabilities differ by more than ``MARGIN``, so a near-tie that
either package could break either way cannot pass or fail a case.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as j_moe
from repro_torch import tree as tr
from repro_torch.configs import MoEConfig
from repro_torch.core.mesh import LocalMesh
from repro_torch.models import moe

from helpers.dist_torch import start_ranks, wait_ranks

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# f32 on both sides, the same formulas, products and sums in another order
# (test_torch_transformer.py's TOL)
TOL = {"atol": 1e-5, "rtol": 1e-5}
# gradients: the relative L2 error of each leaf (test_torch_lm_train.py's)
REL_L2 = 1e-5
# ... but the router's at top-1: its gates are g / g, whose derivative is
# 0 and reads f32 rounding in both packages (against the port's own f64
# route, JAX's router gradient reads 6.0e-6, the port's 1.6e-5); the
# balance loss's part of the gradient is held by the top-2 and top-4 cases
TOP1_ROUTER_REL_L2 = 5e-5
# the least gap between a token's k-th and (k+1)-th probability
MARGIN = 1e-5
D, T = 16, 40
DIST_WORLD = 4
_j_local = jax.jit(j_moe._moe_apply_local, static_argnums=2)

LOCAL_CASES = {
    "top2": dict(n_experts=4, top_k=2, d_ff=32),
    "top1_shared": dict(n_experts=8, top_k=1, d_ff=16, shared_experts=1),
    "top4": dict(n_experts=16, top_k=4, d_ff=24),
    "drops": dict(n_experts=4, top_k=2, d_ff=32, capacity_factor=0.5),
    "drops_top4_shared": dict(n_experts=16, top_k=4, d_ff=24,
                              capacity_factor=0.7, shared_experts=2),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _case(fields: dict, seed: int = 0, t: int = T):
    """JAX's weights and seeded tokens, as JAX arrays and as tensors."""
    j_params = j_moe.init_moe_params(jax.random.PRNGKey(seed), D,
                                     JMoEConfig(**fields), jnp.float32)
    x = np.random.default_rng(seed).standard_normal((t, D)).astype(
        np.float32)
    return j_params, x, tr.map_tree(_t, jax.tree.map(np.asarray, j_params))


def _assert_margins(router: np.ndarray, x: np.ndarray, k: int) -> None:
    """Each token's k-th probability exceeds its (k+1)-th by MARGIN."""
    logits = x.astype(np.float64) @ router.astype(np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    if k < p.shape[1]:
        assert (p[:, k - 1] - p[:, k]).min() > MARGIN


@pytest.mark.parametrize("tokens,fields", [
    (40, dict(n_experts=4, top_k=2, d_ff=8)),
    (3, dict(n_experts=4, top_k=2, d_ff=8)),           # the floor of 8
    (16382, dict(n_experts=16, top_k=4, d_ff=8)),      # dbrx's prefill
    (16382, dict(n_experts=128, top_k=1, d_ff=8)),     # llama4's
    (4096, dict(n_experts=16, top_k=4, d_ff=8)),
    (1000, dict(n_experts=8, top_k=2, d_ff=8, capacity_factor=0.37)),
    (2, dict(n_experts=128, top_k=1, d_ff=8))])
def test_capacity_matches_jax(tokens, fields):
    assert moe.capacity(tokens, MoEConfig(**fields)) == j_moe.capacity(
        tokens, JMoEConfig(**fields))


@pytest.mark.parametrize("fields", [LOCAL_CASES["top2"],
                                    LOCAL_CASES["drops_top4_shared"]])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_init_moe_params_has_jaxs_leaves(fields, lead):
    """The same tree, leaf shapes and dtypes as JAX's init (``lead``
    stacked as the transformer's ``vmap`` over groups), the router in f32
    and each leaf drawn at JAX's scale, ``fan_in ** -0.5`` (its sample
    deviation within four standard errors)."""
    j_params = j_moe.init_moe_params(jax.random.PRNGKey(0), 64,
                                     JMoEConfig(**fields), jnp.bfloat16)
    params = moe.init_moe_params(torch.Generator().manual_seed(0), 64,
                                 MoEConfig(**fields), torch.bfloat16,
                                 lead=lead)
    j_paths = [tr.key_of(tuple(getattr(k, "key", k) for k in p)) for p, _ in
               jax.tree_util.tree_leaves_with_path(j_params)]
    assert [tr.key_of(p) for p, _ in tr.leaves_with_paths(params)] == j_paths
    for got, want in zip(tr.leaves(params), jax.tree.leaves(j_params)):
        assert got.shape == (*lead, *want.shape)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        scale = want.shape[-2] ** -0.5          # every leaf's fan-in
        assert abs(float(got.float().std()) - scale) <= (
            4 * scale / np.sqrt(2 * got.numel()))
    assert params["router"].dtype == torch.float32


@pytest.mark.parametrize("name", sorted(LOCAL_CASES))
def test_local_route_matches_jax(name):
    """Output, ``lb_loss``, ``dropped`` and the experts picked, on JAX's
    weights; the ``drops`` cases drop assignments (asserted)."""
    fields = LOCAL_CASES[name]
    j_params, x, params = _case(fields, seed=len(name))
    _assert_margins(np.asarray(j_params["router"]), x, fields["top_k"])
    want, j_aux = _j_local(j_params, jnp.asarray(x),
                                   JMoEConfig(**fields))
    got, aux = moe._moe_apply_local(params, _t(x), MoEConfig(**fields))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux["lb_loss"]),
                               float(j_aux["lb_loss"]), **TOL)
    assert int(aux["dropped"]) == int(j_aux["dropped"])
    if name.startswith("drops"):
        assert int(aux["dropped"]) > 0
    _, j_idx = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x) @ j_params["router"], axis=-1), fields["top_k"])
    _, _, idx = moe._route(params["router"], _t(x), fields["top_k"])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))


@pytest.mark.parametrize("name", ["top2", "top4", "drops_top4_shared"])
def test_zero_router_picks_the_lowest_experts(name):
    """A zero router gives every token a uniform row: JAX's ``top_k``
    takes experts 0..k-1 (``torch.topk`` would not), so both packages
    fill those experts, drop the rest past capacity, and agree."""
    fields = LOCAL_CASES[name]
    j_params, x, params = _case(fields, seed=3)
    j_params = dict(j_params, router=jnp.zeros_like(j_params["router"]))
    params["router"].zero_()
    k = fields["top_k"]
    _, _, idx = moe._route(params["router"], _t(x), k)
    assert (idx == torch.arange(k)).all()
    want, j_aux = _j_local(j_params, jnp.asarray(x),
                                   JMoEConfig(**fields))
    got, aux = moe._moe_apply_local(params, _t(x), MoEConfig(**fields))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert int(aux["dropped"]) == int(j_aux["dropped"]) > 0
    np.testing.assert_allclose(float(aux["lb_loss"]),
                               float(j_aux["lb_loss"]), **TOL)


@pytest.mark.parametrize("name", ["top2", "top1_shared", "drops_top4_shared"])
def test_local_route_gradients_match_jax(name):
    """The gradient of ``sum(out * cotangent) + lb_loss`` with respect to
    every weight and to x, against ``jax.grad``: the gates' top-k values,
    the dispatch gather, the segment sum and the balance loss."""
    fields = LOCAL_CASES[name]
    j_params, x, params = _case(fields, seed=7)
    _assert_margins(np.asarray(j_params["router"]), x, fields["top_k"])
    ct = np.random.default_rng(8).standard_normal((T, D)).astype(np.float32)

    def j_loss(p, a):
        y, aux = j_moe._moe_apply_local(p, a, JMoEConfig(**fields))
        return (y * ct).sum() + aux["lb_loss"]

    j_gp, j_gx = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
        j_params, jnp.asarray(x))
    leaves = [p.requires_grad_() for p in tr.leaves(params)]
    xt = _t(x).requires_grad_()
    y, aux = moe._moe_apply_local(tr.unflatten(params, leaves), xt,
                                  MoEConfig(**fields))
    grads = torch.autograd.grad((y * _t(ct)).sum() + aux["lb_loss"],
                                [*leaves, xt])
    paths = [tr.key_of(p) for p, _ in tr.leaves_with_paths(params)] + ["x"]
    for path, g, w in zip(paths, grads, [*jax.tree.leaves(j_gp), j_gx]):
        w = np.asarray(w, np.float64)
        err = np.linalg.norm(g.numpy().astype(np.float64) - w)
        tol = (TOP1_ROUTER_REL_L2 if path == "router"
               and fields["top_k"] == 1 else REL_L2)
        assert err <= tol * np.linalg.norm(w), (path, err)


# ------------------------------------------------------ expert parallel

@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """JAX's ``moe_apply`` under hints on (1, 4) and (2, 2) meshes of 4
    host devices, run once in a subprocess (``helpers/moe_sharded_jax.py``)."""
    out = tmp_path_factory.mktemp("moe_sharded") / "jax.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "helpers" /
                             "moe_sharded_jax.py"), str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    return pickle.loads(out.read_bytes())


SHARDED_CASES = ("1x4", "1x4_drops", "2x2", "2x2_drops",
                 "experts_do_not_divide", "tokens_do_not_divide")


def _sharded(case: dict, mesh):
    params = tr.map_tree(_t, case["params"])
    return moe.moe_apply_sharded(params, _t(case["x"]),
                                 MoEConfig(**case["fields"]), mesh,
                                 ("data",), "model")


@pytest.mark.parametrize("name", SHARDED_CASES)
def test_sharded_route_on_local_mesh_matches_jaxs(jax_sharded, name):
    """``moe_apply_sharded`` on a ``LocalMesh`` of JAX's mesh shape
    against JAX's sharded route: output, ``lb_loss`` (a ``pmean`` over
    the data shards) and ``dropped`` (a ``psum`` over every axis)."""
    case = jax_sharded[name]
    _assert_margins(case["params"]["router"], case["x"],
                    case["fields"]["top_k"])
    got, aux = _sharded(case, LocalMesh(case["shape"], ("data", "model"),
                                        "cpu"))
    assert got.shape == case["out"].shape
    np.testing.assert_allclose(got.numpy(), case["out"], **TOL)
    np.testing.assert_allclose(float(aux["lb_loss"]), case["lb_loss"], **TOL)
    assert int(aux["dropped"]) == case["dropped"]
    if name.endswith("drops"):
        assert case["dropped"] > 0


def test_sharded_route_differs_from_local_at_dp_2_as_jaxs_does(jax_sharded):
    """At dp = 2 capacity is a data shard's: JAX's sharded route drops
    other assignments than its local route, and so does the port's."""
    case = jax_sharded["2x2_drops"]
    assert case["dropped"] != case["local_dropped"]
    _, aux = _sharded(case, LocalMesh((2, 2), ("data", "model"), "cpu"))
    _, loc = moe._moe_apply_local(tr.map_tree(_t, case["params"]),
                                  _t(case["x"]), MoEConfig(**case["fields"]))
    assert int(aux["dropped"]) == case["dropped"]
    assert int(loc["dropped"]) == case["local_dropped"]


@pytest.mark.parametrize("name", ["1x4", "1x4_drops"])
def test_sharded_route_equals_the_local_route_at_dp_1(jax_sharded, name):
    """At dp = 1 every shard routes all tokens with the same capacity: the
    same drops and ``lb_loss`` as the local route, bitwise, and the output
    within rounding (the f32 partials are summed in another order)."""
    case = jax_sharded[name]
    params = tr.map_tree(_t, case["params"])
    got, aux = _sharded(case, LocalMesh((1, 4), ("data", "model"), "cpu"))
    want, loc = moe._moe_apply_local(params, _t(case["x"]),
                                     MoEConfig(**case["fields"]))
    assert int(aux["dropped"]) == int(loc["dropped"]) == case["dropped"]
    assert torch.equal(aux["lb_loss"], loc["lb_loss"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("name", ["experts_do_not_divide",
                                  "tokens_do_not_divide"])
def test_sharded_route_falls_back_to_local_as_jaxs(jax_sharded, name):
    """6 experts over 4 model shards, or 63 tokens over 2 data shards:
    JAX's sharded route is its local route, bitwise; the port's is its
    local route, bitwise."""
    case = jax_sharded[name]
    np.testing.assert_array_equal(case["out"], case["local_out"])
    got, aux = _sharded(case, LocalMesh(case["shape"], ("data", "model"),
                                        "cpu"))
    want, loc = moe._moe_apply_local(tr.map_tree(_t, case["params"]),
                                     _t(case["x"]),
                                     MoEConfig(**case["fields"]))
    assert torch.equal(got, want) and torch.equal(aux["lb_loss"],
                                                  loc["lb_loss"])


def test_moe_apply_picks_the_route_by_mesh(jax_sharded):
    case = jax_sharded["2x2_drops"]
    params, x = tr.map_tree(_t, case["params"]), _t(case["x"])
    cfg = MoEConfig(**case["fields"])
    mesh = LocalMesh((2, 2), ("data", "model"), "cpu")
    assert torch.equal(moe.moe_apply(params, x, cfg)[0],
                       moe._moe_apply_local(params, x, cfg)[0])
    assert torch.equal(moe.moe_apply(params, x, cfg, mesh)[0],
                       moe.moe_apply_sharded(params, x, cfg, mesh)[0])


@pytest.fixture(scope="module")
def dist_ranks(jax_sharded, tmp_path_factory):
    """4 ``gloo`` ranks running every sharded case on a ``DistMesh``."""
    tmp = tmp_path_factory.mktemp("moe_dist")
    (tmp / "cases.pkl").write_bytes(pickle.dumps(jax_sharded))
    procs = start_ranks(DIST_WORLD, "helpers.moe_dist_rank:sharded_cases",
                        tmp, env_extra={"MOE_DIST_DIR": str(tmp)})
    try:
        results = wait_ranks(procs, timeout=150)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return tmp, results


@pytest.mark.parametrize("name", SHARDED_CASES)
def test_dist_mesh_matches_local_mesh(jax_sharded, dist_ranks, name):
    """Every rank of a ``DistMesh`` of the case's shape gives the global
    output of the ``LocalMesh`` route (its psum and all-gather over
    ``gloo``), the same ``lb_loss`` and ``dropped``."""
    tmp, results = dist_ranks
    case = jax_sharded[name]
    want, aux = _sharded(case, LocalMesh(case["shape"], ("data", "model"),
                                         "cpu"))
    for rank, res in enumerate(results):
        got = np.load(tmp / f"{name}_rank{rank}.npy")
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6)
        assert res[name]["local_shards"] == [rank]
        np.testing.assert_allclose(res[name]["lb_loss"],
                                   float(aux["lb_loss"]), rtol=1e-6, atol=0)
        assert res[name]["dropped"] == int(aux["dropped"])
