"""The port's sharding plan (``launch.shardings``, ``launch.mesh``,
``launch.flops_est``) on the CPU against the
JAX package's, on JAX's ``AbstractMesh`` (no devices, no compile).

For every one of the 40 (arch, shape) cells on both production meshes
(16 x 16 and 2 x 16 x 16): the param specs (``lm_param_specs`` in ``tp``
and ``fsdp`` modes), the state specs (ZeRO-1 on and off, FSDP on and off)
and the batch specs equal JAX's entry for entry, leaf for leaf, and so
does every leaf's per-shard shape (``NamedSharding.shard_shape``; the
port's params are meta tensors, JAX's ``eval_shape`` structs, and their
shapes equal too).  ``model_flops`` is JAX's float for every cell.
Specs, shapes and FLOP counts compare exactly.  The sharding hints are
held in ``test_torch_sharding_hints.py``.
"""

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import base as j_base
from repro.launch import flops_est as j_flops
from repro.launch import shardings as j_sh
from repro.launch import steps as j_steps
from repro_torch import tree as tr
from repro_torch.configs import base
from repro_torch.core.mesh import LocalMesh
from repro_torch.launch import flops_est, mesh as pmesh
from repro_torch.launch import shardings as sh
from repro_torch.launch import steps
from repro_torch.launch.dryrun import meta_generator

torch.set_num_threads(1)

CELLS = [(spec.arch_id, shp.name) for spec, shp in base.all_cells()]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _is_jp(x):
    return isinstance(x, JP)


def _j_leaves(tree):
    """JAX leaves as (path, leaf), paths as tuples of keys and indices,
    specs as leaves."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_jp)
    out = []
    for path, leaf in flat:
        key = tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path)
        out.append((key, leaf))
    return out


def _spec_rows(j_tree, p_tree):
    """Both spec trees as [(path, entries)], asserting the leaves are
    specs."""
    j = [(k, tuple(s)) for k, s in _j_leaves(j_tree)]
    p = [(k, tuple(s)) for k, s in tr.leaves_with_paths(p_tree)]
    assert all(isinstance(s, sh.P) for _, s in tr.leaves_with_paths(p_tree))
    return j, p


def _cell(arch, shape):
    j_bundle = j_steps.build_bundle(j_base.get_arch(arch), shape)
    p_bundle = steps.build_bundle(base.get_arch(arch), shape, device="meta")
    j_params = jax.eval_shape(j_bundle.init_params, jax.random.PRNGKey(0))
    params = p_bundle.init_params(meta_generator())
    p_params = params.tree() if hasattr(params, "tree") else params
    return j_bundle, p_bundle, j_params, p_params


def _shard_or_raise(make, shape):
    """A leaf's shard shape, or "raises" where the spec does not fit."""
    try:
        return tuple(make().shard_shape(shape))
    except ValueError:
        return "raises"


def _assert_shapes(j_specs, j_tree, p_specs, p_tree, amesh, pm):
    """Leaf shapes equal, and every leaf's shard shape under the specs
    (or both raise: JAX's fsdp mode puts ``model`` on the group dim of a
    stacked MoE expert leaf, ROADMAP Queue C)."""
    j_sh = [_shard_or_raise(lambda: JNamedSharding(amesh, s), x.shape)
            for (_, x), (_, s) in zip(_j_leaves(j_tree),
                                      _j_leaves(j_specs), strict=True)]
    p_sh = [_shard_or_raise(lambda: sh.NamedSharding(pm, s), tuple(x.shape))
            for x, s in zip(tr.leaves(p_tree), tr.leaves(p_specs),
                            strict=True)]
    assert [tuple(x.shape) for _, x in _j_leaves(j_tree)] == \
        [tuple(x.shape) for x in tr.leaves(p_tree)]
    assert j_sh == p_sh


def _batch_specs(mod, bundle, batch, mesh):
    if bundle.family == "lm":
        return mod.lm_batch_specs(bundle.cfg, bundle.shape, mesh)
    if bundle.family == "gnn":
        return mod.gnn_batch_specs(batch, mesh)
    return mod.recsys_batch_specs(bundle.cfg, bundle.shape, mesh)


def _param_specs(mod, bundle, params, mesh, mode):
    if bundle.family == "lm":
        return mod.lm_param_specs(bundle.cfg, mesh, mode=mode)
    if bundle.family == "gnn":
        return mod.gnn_param_specs(params, mesh)
    return mod.recsys_param_specs(bundle.cfg, mesh)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_sharding_plan_matches_jax(arch, shape):
    """Param, state and batch specs and every leaf's shard shape, on both
    production meshes, equal JAX's."""
    j_bundle, p_bundle, j_params, p_params = _cell(arch, shape)
    j_batch, p_batch = j_bundle.input_specs(), p_bundle.input_specs()
    for name, (shp, names) in MESHES.items():
        amesh = AbstractMesh(shp, names)
        pm = LocalMesh(shp, names, "meta")
        assert pmesh.mesh_axes(pm) == pmesh.Axes(**vars(
            j_sh.mesh_axes(amesh)))
        for mode in ("tp", "fsdp"):
            jp = _param_specs(j_sh, j_bundle, j_params, amesh, mode)
            pp = _param_specs(sh, p_bundle, p_params, pm, mode)
            j_rows, p_rows = _spec_rows(jp, pp)
            assert j_rows == p_rows, (name, mode)
            _assert_shapes(jp, j_params, pp, p_params, amesh, pm)
            for zero1 in (True, False):
                for fsdp in (True, False):
                    js = j_sh.state_specs(jp, j_params, amesh, zero1=zero1,
                                          fsdp=fsdp)
                    ps = sh.state_specs(pp, p_params, pm, zero1=zero1,
                                        fsdp=fsdp)
                    j_rows, p_rows = _spec_rows(js, ps)
                    assert j_rows == p_rows, (name, mode, zero1, fsdp)
                    for k in ("m", "v"):
                        _assert_shapes(js["opt"][k], j_params,
                                       ps["opt"][k], p_params, amesh, pm)
        jb = _batch_specs(j_sh, j_bundle, j_batch, amesh)
        pb = _batch_specs(sh, p_bundle, p_batch, pm)
        j_rows, p_rows = _spec_rows(jb, pb)
        assert j_rows == p_rows, name
        _assert_shapes(jb, j_batch, pb, p_batch, amesh, pm)
        assert [str(x.dtype) for _, x in _j_leaves(j_batch)] == [
            str(x.dtype).replace("torch.", "") for x in tr.leaves(p_batch)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_matches_jax(arch, shape):
    j_bundle = j_steps.build_bundle(j_base.get_arch(arch), shape)
    p_bundle = steps.build_bundle(base.get_arch(arch), shape, device="meta")
    assert flops_est.model_flops(p_bundle) == j_flops.model_flops(j_bundle)


def test_production_meshes_and_axes():
    """Meta meshes of JAX's shapes and axes; nothing is allocated."""
    single = pmesh.make_production_mesh()
    multi = pmesh.make_production_mesh(multi_pod=True)
    assert (single.shape, single.axis_names, single.p) == (
        (16, 16), ("data", "model"), 256)
    assert (multi.shape, multi.axis_names, multi.p) == (
        (2, 16, 16), ("pod", "data", "model"), 512)
    assert single.device.type == multi.device.type == "meta"
    assert pmesh.mesh_axes(multi).sizes(multi) == {"dp": 32, "model": 16,
                                                   "flat": 512}
    assert pmesh.default_grid(12) == (3, 4)
    grid = pmesh.make_grid_mesh(2, 3, device="cpu")
    assert (grid.shape, grid.axis_names) == ((2, 3), ("rows", "cols"))
    assert pmesh.make_host_mesh(4, device="cpu").shape == (4,)


@pytest.mark.parametrize("spec,shape", [
    (("model", None), (7, 3)),        # 7 rows over 16
    (("foo",), (16,)),                # no such axis
    (("data", "data"), (16, 16)),     # an axis twice
    ((("data", "data"),), (256,)),
    ((("pod", "data"), "model"), (64, 32)),
    ((None, ("data", "model")), (3, 512)),
    ((), (5, 5)),
])
def test_named_sharding_raises_where_jaxs_does(spec, shape):
    """JAX raises (a ``ValueError``, or its duplicate-axis error) where
    the port raises ``ValueError``, and the shard shapes agree
    otherwise."""
    amesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    pm = LocalMesh((2, 16, 16), ("pod", "data", "model"), "meta")
    try:
        want = JNamedSharding(amesh, JP(*spec)).shard_shape(shape)
    except Exception as e:                          # noqa: BLE001
        want = type(e)
    if isinstance(want, type):
        with pytest.raises(ValueError):
            sh.NamedSharding(pm, sh.P(*spec)).shard_shape(shape)
    else:
        assert sh.NamedSharding(pm, sh.P(*spec)).shard_shape(shape) == \
            tuple(want)
    assert tuple(sh.P(*spec)) == tuple(JP(*spec))


def test_p_is_a_leaf_and_normalises_as_jaxs():
    """``P`` is no tuple to the tree code, so ``P()`` stays a leaf; its
    entries normalise as JAX's (a one-name tuple is the name)."""
    tree = {"a": sh.P(), "b": [sh.P("x", None)]}
    assert tr.leaves(tree) == [sh.P(), sh.P("x", None)]
    assert tr.map_tree(lambda s: len(s), tree) == {"a": 0, "b": [2]}
    for spec in [(("data",), None), (["a", "b"],), ((), "m"), (None,)]:
        assert tuple(sh.P(*spec)) == tuple(JP(*spec))
    assert sh.P("a") == ("a",) and sh.P("a") == sh.P(("a",))
    assert sh.P("a", None) != sh.P("a")
