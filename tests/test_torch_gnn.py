"""The port's GNN family on the CPU against the JAX package: the configs,
the segment ops of ``models.gnn.common`` (bitwise), ``shard_node_array``,
the neighbour sampler and its stream (bitwise), ``gnn_batch`` (bitwise),
the four architectures' losses and gradients on the 12 reduced cells of
``tests/test_arch_smoke.py``, the bundle's train step, the train
launcher against JAX's, checkpoints in both directions and the planted
fault of ``chip_smoke.py`` path 13.  JAX's weights are carried over with
``models.convert.gnn_from_jax_params``.

Tolerances: the index code is bitwise.  The models run the same f32
formulas, but XLA's and torch's matrix products and reductions round in
another order: on the 12 cells the loss reads at most 1.9e-7 relative
and a gradient leaf at most 1.6e-6 relative L2, so ``LOSS_RTOL`` and
``GRAD_REL`` sit 50 and 60 times above.
"""

import ast
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs.base import get_arch as j_get_arch
from repro.data import pipeline as j_pipeline
from repro.data import synthetic as j_syn
from repro.graphs import csr_from_coo as j_csr_from_coo
from repro.graphs import erdos_renyi as j_erdos_renyi
from repro.graphs.formats import shard_node_array as j_shard_node_array
from repro.graphs.sampler import NeighborSampler as JNeighborSampler
from repro.launch import steps as j_steps
from repro.launch import train as j_train_launcher
from repro.models.gnn import common as j_common
from repro.models.gnn import models as j_models
from repro.optim import adamw as j_adamw
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch import tree as tr
from repro_torch.configs import GNN_SHAPES, get_arch
from repro_torch.configs import base
from repro_torch.core.partition import Partition1D
from repro_torch.data import pipeline
from repro_torch.data import synthetic as syn
from repro_torch.graphs import csr_from_coo, erdos_renyi, shard_node_array
from repro_torch.graphs.sampler import NeighborSampler
from repro_torch.launch import steps
from repro_torch.launch import train as train_launcher
from repro_torch.models.convert import (gnn_from_jax_params, gnn_to_numpy,
                                        train_state_from_jax,
                                        train_state_to_numpy)
from repro_torch.models.gnn import common as C
from repro_torch.models.gnn import models
from repro_torch.optim import adamw
from repro_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

GNN_ARCHS = ("gcn_cora", "gatedgcn", "schnet", "graphcast")
CELLS = ("full_graph_sm", "minibatch_lg", "molecule")
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
OPT = adamw.AdamWConfig(total_steps=10, warmup_steps=2)
J_OPT = j_adamw.AdamWConfig(total_steps=10, warmup_steps=2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _same_bits(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        a = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert a.dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(_bits(a), _bits(want[k]), err_msg=k)


def _cell(arch_id, shape_name, seed=3):
    """The reduced cell in both packages, from JAX's seed-0 weights:
    (port bundle, JAX bundle, port params, JAX params, port batch, JAX
    batch)."""
    j_b = j_steps.build_bundle(j_get_arch(arch_id), shape_name, reduced=True,
                               opt_cfg=J_OPT)
    b = steps.build_bundle(get_arch(arch_id), shape_name, reduced=True,
                           device="cpu", opt_cfg=OPT)
    j_params = j_b.init_params(jax.random.PRNGKey(0))
    params = gnn_from_jax_params(jax.tree.map(np.asarray, j_params), "cpu")
    return (b, j_b, params, j_params, b.make_batch(seed),
            jax.tree.map(jnp.asarray, j_b.make_batch(seed)))


def _grads_close(grads: list, j_grads, params) -> None:
    paths = [tr.key_of(p) for p, _ in tr.leaves_with_paths(params)]
    j_leaves = jax.tree.leaves(j_grads)
    assert len(grads) == len(j_leaves) == len(paths)
    for path, g, jg in zip(paths, grads, j_leaves):
        assert bool(torch.isfinite(g).all()), path
        assert _rel_l2(g, jg) <= GRAD_REL, (path, _rel_l2(g, jg))


# ----------------------------------------------------------------- configs

@pytest.mark.parametrize("arch_id", GNN_ARCHS)
def test_configs_are_the_jax_configs(arch_id):
    spec, j_spec = get_arch(arch_id), j_get_arch(arch_id)
    assert spec.family == j_spec.family == "gnn"
    assert spec.source == j_spec.source
    for mine, theirs in ((spec.config, j_spec.config),
                         (spec.reduced, j_spec.reduced)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert [dataclasses.asdict(s) for s in spec.shapes] == [
        dataclasses.asdict(s) for s in j_spec.shapes]


def test_gnn_shapes_and_reduced_shapes_are_jax_s():
    assert [dataclasses.asdict(s) for s in GNN_SHAPES] == [
        dataclasses.asdict(s) for s in j_base.GNN_SHAPES]
    for shape in GNN_SHAPES:
        assert dataclasses.asdict(steps.reduce_shape(shape, "gnn")) == \
            dataclasses.asdict(j_steps.reduce_shape(shape, "gnn"))
    assert base.ARCH_IDS == j_base.ARCH_IDS


# --------------------------------------------------------------- index ops

def _messages(seed=0, e=40, n=9, d=3):
    """Messages over n nodes with padding (dst = -1, src = -1) and node
    n - 1 receiving nothing (an empty segment)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(-1, n, e).astype(np.int32)
    dst = rng.integers(-1, n - 1, e).astype(np.int32)
    dst[:5] = -1
    msg = rng.standard_normal((e, d)).astype(np.float32)
    return src, dst, msg, n


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_aggregate_is_bitwise_jax(op):
    src, dst, msg, n = _messages()
    got = C.aggregate(_t(msg), _t(dst), n, op)
    want = np.asarray(j_common.aggregate(jnp.asarray(msg), jnp.asarray(dst),
                                         n, op))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert not got[n - 1].any()           # the empty segment is 0
    with pytest.raises(ValueError):
        C.aggregate(_t(msg), _t(dst), n, "min")


def test_gather_mask_and_degrees_are_bitwise_jax():
    src, dst, msg, n = _messages(seed=1)
    assert (src < 0).any()                # -1 reads row 0
    np.testing.assert_array_equal(
        C.gather_src(_t(msg), _t(src)).numpy(),
        np.asarray(j_common.gather_src(jnp.asarray(msg), jnp.asarray(src))))
    np.testing.assert_array_equal(C.edge_mask(_t(dst)).numpy(),
                                  np.asarray(j_common.edge_mask(dst)))
    src = np.maximum(src, 0)              # a batch's sources are >= 0
    for got, want in zip(C.degrees(_t(src), _t(dst), n),
                         j_common.degrees(jnp.asarray(src),
                                          jnp.asarray(dst), n)):
        np.testing.assert_array_equal(_bits(got.numpy()),
                                      _bits(np.asarray(want)))


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_graph_pool_is_bitwise_jax(op):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((30, 4)).astype(np.float32)
    gid = np.minimum(np.arange(30) // 7, 3).astype(np.int32)
    got = C.graph_pool(_t(x), _t(gid), 5, op)       # graph 4 is empty
    want = np.asarray(j_common.graph_pool(jnp.asarray(x), jnp.asarray(gid),
                                          5, op))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_mlp_layer_norm_and_mse_match_jax():
    """``init_mlp(bias=False)``, ``apply_mlp`` with another activation and
    a final one, the f32-statistics layer norm and ``node_mse``."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((17, 6)).astype(np.float32)
    layers = C.init_mlp(torch.Generator().manual_seed(0), (6, 5, 4),
                        bias=False)
    assert [sorted(layer) for layer in layers] == [["w"], ["w"]]
    j_layers = [{"w": jnp.asarray(layer["w"].numpy())} for layer in layers]
    got = C.apply_mlp(layers, _t(x), act=models._ssp, final_act=True)
    want = j_common.apply_mlp(j_layers, jnp.asarray(x),
                              act=j_models._ssp, final_act=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    ln = {"scale": _t(rng.standard_normal(6).astype(np.float32)),
          "bias": _t(rng.standard_normal(6).astype(np.float32))}
    got = C.apply_layer_norm(ln, _t(x).to(torch.bfloat16))
    want = j_common.apply_layer_norm(
        jax.tree.map(lambda a: jnp.asarray(a.numpy()), ln),
        jnp.asarray(x).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2**-7,
                               atol=2**-7)
    t = rng.standard_normal((17, 6)).astype(np.float32)
    valid = rng.random(17) < 0.6
    np.testing.assert_allclose(
        float(C.node_mse(_t(x), _t(t), _t(valid))),
        float(j_common.node_mse(jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(valid))), rtol=1e-6)


def test_init_mlp_defaults_draw_deepfm_s_layers():
    """DeepFM's ``init_mlp`` call: f32 weights and zero biases, the draws
    of ``torch.randn`` scaled by fan-in ** -0.5."""
    gen = torch.Generator().manual_seed(5)
    layers = C.init_mlp(gen, (4, 3, 1))
    ref = torch.Generator().manual_seed(5)
    for layer, (d_in, d_out) in zip(layers, ((4, 3), (3, 1))):
        w = torch.randn((d_in, d_out), generator=ref).mul_(d_in ** -0.5)
        assert torch.equal(layer["w"], w)
        assert torch.equal(layer["b"], torch.zeros(d_out))


@pytest.mark.parametrize("fill", [0.0, -1])
def test_shard_node_array_is_bitwise_jax(fill):
    from repro.core.partition import Partition1D as JPartition1D

    x = np.random.default_rng(4).standard_normal((101, 3)).astype(np.float32)
    got = shard_node_array(x, Partition1D(101, 8), fill=fill)
    want = j_shard_node_array(x, JPartition1D(101, 8), fill=fill)
    assert got.shape == (104, 3)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------- sampler

def _samplers(n=500, deg=8, seed=0):
    src, dst = erdos_renyi(n, avg_degree=deg, seed=seed)
    j_src, j_dst = j_erdos_renyi(n, avg_degree=deg, seed=seed)
    assert np.array_equal(src, j_src) and np.array_equal(dst, j_dst)
    indptr, indices = csr_from_coo(src, dst, n)
    j_indptr, j_indices = j_csr_from_coo(src, dst, n)
    return (NeighborSampler(indptr, indices),
            JNeighborSampler(j_indptr, j_indices), (src, dst, n))


@pytest.mark.parametrize("seeds,fanouts,seed", [
    (np.arange(16), (4, 3), 1), (np.arange(8), (5,), 3),
    (np.arange(8), (4, 2), 42)])
def test_sampler_is_bitwise_jax(seeds, fanouts, seed):
    s, js, (src, dst, n) = _samplers()
    kw = dict(seed=seed, n_pad=512, e_pad=512, d_feat=8)
    batch = s.sample(seeds, fanouts, **kw)
    _same_bits(batch, js.sample(seeds, fanouts, **kw))
    n_real = int(batch["valid_nodes"].sum())
    layer, want_n, want_e = len(seeds), len(seeds), 0
    for f in fanouts:
        layer *= f
        want_n, want_e = want_n + layer, want_e + layer
    assert n_real == want_n
    e_mask = batch["edge_dst"] >= 0
    assert int(e_mask.sum()) == want_e
    assert (batch["edge_src"][e_mask] < n_real).all()
    assert (batch["edge_dst"][e_mask] < n_real).all()
    adj = set(zip(src.tolist(), dst.tolist()))
    gids = batch["global_ids"]
    for es, ed in zip(batch["edge_src"][e_mask], batch["edge_dst"][e_mask]):
        child, parent = int(gids[es]), int(gids[ed])
        assert child == parent or (parent, child) in adj
    _same_bits(s.sample(seeds, fanouts, **kw), batch)   # deterministic


def test_sampler_with_features_and_isolated_parents():
    """Stored features are gathered (not drawn); a parent with no
    neighbours samples itself."""
    indptr = np.array([0, 2, 2, 3], np.int64)           # node 1 isolated
    indices = np.array([1, 2, 0], np.int64)
    feats = np.arange(12, dtype=np.float32).reshape(3, 4)
    kw = dict(seed=7, n_pad=16, e_pad=16, d_feat=4)
    batch = NeighborSampler(indptr, indices, feats).sample(
        np.array([0, 1]), (3,), **kw)
    _same_bits(batch, JNeighborSampler(indptr, indices, feats).sample(
        np.array([0, 1]), (3,), **kw))
    assert (batch["global_ids"][5:8] == 1).all()        # node 1's children
    np.testing.assert_array_equal(batch["node_feats"][:8],
                                  feats[batch["global_ids"][:8]])


def test_sampler_samples_an_isolated_last_node_where_jax_raises():
    """An isolated parent past the last neighbour list (an R-MAT graph's
    isolated tail) samples itself; JAX's sampler indexes one past
    ``indices`` there and raises."""
    indptr = np.array([0, 2, 3, 3], np.int64)           # node 2 isolated
    indices = np.array([1, 2, 0], np.int64)
    kw = dict(seed=3, n_pad=16, e_pad=16, d_feat=2)
    with pytest.raises(IndexError):
        JNeighborSampler(indptr, indices).sample(np.array([2, 0]), (2,),
                                                 **kw)
    batch = NeighborSampler(indptr, indices).sample(np.array([2, 0]), (2,),
                                                    **kw)
    assert batch["global_ids"][:2].tolist() == [2, 0]
    assert (batch["global_ids"][2:4] == 2).all()        # node 2's children
    assert set(batch["global_ids"][4:6].tolist()) <= {1, 2}


def test_graph_minibatch_stream_is_bitwise_jax():
    s, js, _ = _samplers()
    kw = dict(n_pad=128, e_pad=128, d_feat=4, seed=5)
    st = pipeline.graph_minibatch_stream(s, 8, (3, 2), **kw)
    j_st = j_pipeline.graph_minibatch_stream(js, 8, (3, 2), **kw)
    try:
        for want_step in range(3):
            (step, b), (j_step, jb) = next(st), next(j_st)
            assert step == j_step == want_step
            assert b["node_feats"].shape == (128, 4)
            _same_bits(b, jb)
    finally:
        st.close()
        j_st.close()
    resumed = pipeline.graph_minibatch_stream(s, 8, (3, 2), start_step=2,
                                              **kw)
    step, b = next(resumed)
    resumed.close()
    assert step == 2
    _same_bits(b, jb)


# --------------------------------------------------------------- gnn_batch

@pytest.mark.parametrize("arch_id", GNN_ARCHS)
@pytest.mark.parametrize("shape_name", [s.name for s in GNN_SHAPES])
def test_gnn_batch_is_bitwise_jax(arch_id, shape_name):
    """Every arch x shape, reduced as the bundle reduces it, at both
    pads; the two small shapes also at full size."""
    spec, j_spec = get_arch(arch_id), j_get_arch(arch_id)
    shape = base.get_shape(spec, shape_name)
    j_shape = j_base.get_shape(j_spec, shape_name)
    cases = [(steps.reduce_shape(shape, "gnn"),
              j_steps.reduce_shape(j_shape, "gnn"), pad)
             for pad in (64, 128)]
    if shape_name in ("full_graph_sm", "molecule"):
        cases.append((shape, j_shape, 128))
    for cfg, j_cfg in ((spec.reduced, j_spec.reduced),
                       (spec.config, j_spec.config)):
        for sh, j_sh, pad in cases:
            assert syn._gnn_dims(cfg, sh, pad) == j_syn._gnn_dims(
                j_cfg, j_sh, pad)
            _same_bits(syn.gnn_batch(cfg, sh, seed=11, pad=pad),
                       j_syn.gnn_batch(j_cfg, j_sh, seed=11, pad=pad))


def test_bundle_batches_are_the_jax_bundle_s():
    b, j_b = (steps.build_bundle(get_arch("schnet"), "molecule",
                                 reduced=True, device="cpu"),
              j_steps.build_bundle(j_get_arch("schnet"), "molecule",
                                   reduced=True))
    got = b.make_batch(9)
    assert all(isinstance(v, torch.Tensor) for v in got.values())
    _same_bits({k: v.numpy() for k, v in got.items()}, j_b.make_batch(9))
    assert (b.family, b.step_kind, b.device) == ("gnn", "train",
                                                 torch.device("cpu"))


# ----------------------------------------------------------- the 12 cells

@pytest.mark.parametrize("arch_id", GNN_ARCHS)
@pytest.mark.parametrize("shape_name", CELLS)
def test_loss_and_grads_match_jax(arch_id, shape_name):
    """The reduced cell's forward, loss and every gradient leaf, from one
    set of weights on one batch (the cells of test_arch_smoke.py)."""
    b, j_b, params, j_params, batch, j_batch = _cell(arch_id, shape_name)
    pred = models.forward(b.cfg, params, batch)
    j_pred = jax.jit(lambda p, bt: j_models.forward(j_b.cfg, p, bt))(
        j_params, j_batch)
    assert tuple(pred.shape) == tuple(j_pred.shape)
    assert _rel_l2(pred.detach(), j_pred) <= GRAD_REL
    grads, (loss, aux) = steps.autograd_grads(
        lambda p, bt: models.loss_fn(b.cfg, p, bt))(params, batch)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, bt: j_models.loss_fn(j_b.cfg, p, bt)[0]))(j_params, j_batch)
    assert aux["loss"] == loss
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL,
                               atol=0)
    _grads_close(grads, j_grads, params)


def test_schnet_gradients_are_finite_on_padding_edges():
    """Padding edges (src = dst = 0) have a zero distance but for the
    1e-12 shift; the position gradient stays finite there."""
    b, _, params, _, batch, _ = _cell("schnet", "molecule")
    assert int((batch["edge_dst"] < 0).sum()) > 0
    pos = batch["pos"].clone().requires_grad_()
    loss, _ = models.loss_fn(b.cfg, params, {**batch, "pos": pos})
    (g,) = torch.autograd.grad(loss, pos)
    assert bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)
    grads, _ = steps.autograd_grads(
        lambda p, bt: models.loss_fn(b.cfg, p, bt))(params, batch)
    assert all(bool(torch.isfinite(x).all()) for x in grads)


def test_init_params_has_the_jax_tree_and_scale():
    for arch_id in GNN_ARCHS:
        b = steps.build_bundle(get_arch(arch_id), "full_graph_sm",
                               reduced=True, device="cpu")
        j_b = j_steps.build_bundle(j_get_arch(arch_id), "full_graph_sm",
                                   reduced=True)
        mine = b.init_params(torch.Generator().manual_seed(0))
        theirs = jax.tree_util.tree_flatten_with_path(
            j_b.init_params(jax.random.PRNGKey(0)))[0]
        got = tr.leaves_with_paths(mine)
        assert [tr.key_of(p) for p, _ in got] == [
            "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
            for p, _ in theirs]
        for (path, a), (_, w) in zip(got, theirs):
            assert tuple(a.shape) == w.shape and a.dtype == torch.float32
        again = b.init_params(torch.Generator().manual_seed(0))
        assert all(torch.equal(x, y) for x, y in zip(tr.leaves(mine),
                                                     tr.leaves(again)))


# --------------------------------------------------------- train substrate

@pytest.mark.parametrize("arch_id,shape_name", [
    ("gcn_cora", "full_graph_sm"), ("gatedgcn", "minibatch_lg"),
    ("schnet", "molecule"), ("graphcast", "full_graph_sm")])
def test_bundle_train_steps_match_jax(arch_id, shape_name):
    """Two bundle steps from one state: loss, grad_norm, lr and every
    leaf of the state; the step leaves its input state as it was."""
    b, j_b, params, j_params, _, _ = _cell(arch_id, shape_name)
    state = b.make_state(params)
    j_state = j_b.make_state(j_params)
    before = [x.clone() for x in tr.leaves(state)]
    j_fn = jax.jit(j_b.fn)
    for i in range(2):
        new, m = b.fn(state, b.make_batch(i))
        if i == 0:
            assert all(torch.equal(x, y) for x, y in zip(tr.leaves(state),
                                                         before))
        state = new
        j_state, j_m = j_fn(j_state, j_b.make_batch(i))
        np.testing.assert_allclose(float(m["loss"]), float(j_m["loss"]),
                                   rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(j_m["grad_norm"]), rtol=GRAD_REL)
        np.testing.assert_allclose(float(m["lr"]), float(j_m["lr"]),
                                   rtol=2e-7)
    host = train_state_to_numpy(state)
    j_host = jax.tree.map(np.asarray, j_state)
    for a, w in zip(tr.leaves(host), jax.tree.leaves(j_host)):
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-6)


def test_train_launcher_prints_the_jax_launchers_metric_lines(
        tmp_path, monkeypatch, capsys):
    """Both launchers on gatedgcn REDUCED minibatch_lg, 3 steps, from the
    JAX package's seed-0 weights: the same metric line (step 3, loss)."""
    j_cfg = j_get_arch("gatedgcn").reduced
    j_shape = j_steps.reduce_shape(
        j_base.get_shape(j_get_arch("gatedgcn"), "minibatch_lg"), "gnn")
    j_params = jax.tree.map(np.asarray, j_models.init_params(
        j_cfg, j_shape.d_feat, jax.random.PRNGKey(0)))
    monkeypatch.setattr(models, "init_params",
                        lambda cfg, d_feat, gen: gnn_from_jax_params(
                            j_params, gen.device))
    argv = ["--arch", "gatedgcn", "--shape", "minibatch_lg", "--steps", "3",
            "--ckpt-every", "2", "--reduced"]
    seen = {}
    assert train_launcher.main(argv + ["--device", "cpu", "--ckpt-dir",
                                       str(tmp_path / "port")],
                               on_trainer=lambda t: seen.update(t=t)) == 0
    port_out = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["train"] + argv + [
        "--ckpt-dir", str(tmp_path / "jax")])
    j_train_launcher.main()
    jax_out = capsys.readouterr().out

    def lines(text):
        return [ast.literal_eval(ln) for ln in text.splitlines()
                if ln.startswith("{")]

    mine, theirs = lines(port_out), lines(jax_out)
    assert [m["step"] for m in mine] == [m["step"] for m in theirs] == [3]
    np.testing.assert_allclose([m["loss"] for m in mine],
                               [m["loss"] for m in theirs], rtol=LOSS_RTOL,
                               atol=0)
    assert seen["t"].mgr.all_steps() == [2, 3]
    assert len(seen["t"].step_times) == 3


@pytest.mark.parametrize("arch_id", ["gatedgcn", "graphcast"])
def test_gnn_checkpoints_cross_both_ways(tmp_path, arch_id):
    """A GNN train state the port writes restores in JAX's key layout,
    bitwise, and one JAX writes restores in the port."""
    b, j_b, params, j_params, _, _ = _cell(arch_id, "full_graph_sm")
    state = b.make_state(params)
    host = train_state_to_numpy(state)
    CheckpointManager(str(tmp_path / "port")).save(4, state)
    j_like = j_b.make_state(j_params)
    restored, step = JCheckpointManager(str(tmp_path / "port")).restore(
        j_like)
    assert step == 4
    for a, w in zip(jax.tree.leaves(host), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(_bits(a), _bits(np.asarray(w)))

    j_state = j_b.make_state(jax.tree.map(lambda x: x * 2 + 1, j_params))
    JCheckpointManager(str(tmp_path / "jax")).save(6, j_state)
    got, step = CheckpointManager(str(tmp_path / "jax")).restore(
        tr.map_tree(torch.zeros_like, state))
    assert step == 6
    want = train_state_from_jax(jax.tree.map(np.asarray, j_state), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(tr.leaves(got),
                                                 tr.leaves(want)))
    assert tr.leaves(gnn_to_numpy(got["params"]))[0].dtype == np.float32
    with pytest.raises(ValueError, match="GNN tree"):
        gnn_from_jax_params({"w": np.zeros(2)}, "cpu")


# ------------------------------------------------------------ planted fault

def test_dst_one_node_on_fails_the_gradient_hold():
    """chip_smoke.py path 13's planted fault: every valid edge's dst one
    node on.  The loss and gradients move far past the tolerances."""
    b, _, params, _, batch, _ = _cell("gcn_cora", "full_graph_sm")
    grad_fn = steps.autograd_grads(lambda p, bt: models.loss_fn(b.cfg, p, bt))
    grads, (loss, _) = grad_fn(params, batch)
    dst = batch["edge_dst"]
    n = batch["node_feats"].shape[0]
    bad = {**batch, "edge_dst": torch.where(dst >= 0, (dst + 1) % n, dst)}
    bad_grads, (bad_loss, _) = grad_fn(params, bad)
    worst = max(_rel_l2(g, w) for g, w in zip(bad_grads, grads))
    assert worst > 100 * GRAD_REL
