"""The port's train substrate on the CPU against the JAX package: AdamW,
DeepFM's loss, the train step (microbatches 1 and 2), gradient
compression, checkpoints in both directions, the trainer with its fault
replay and resume, the data pipeline and the train launcher.  Both
packages start from one state, carried across by ``models.convert``."""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch
from repro.data import pipeline as j_pipeline
from repro.launch import steps as j_steps
from repro.launch import train as j_train_launcher
from repro.models.recsys import deepfm as j_deepfm
from repro.optim import adamw as j_adamw
from repro.train import compress as j_comp
from repro.train import trainer as j_trainer
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch import tree as tr
from repro_torch.configs import get_arch
from repro_torch.data import pipeline
from repro_torch.launch import steps
from repro_torch.launch import train as train_launcher
from repro_torch.models.convert import (train_state_from_jax,
                                        train_state_to_numpy)
from repro_torch.models.recsys import deepfm
from repro_torch.optim import adamw
from repro_torch.train import compress as comp
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                       make_compressed_train_step)

torch.set_num_threads(1)

# f32 on both sides, the same formulas; sums (the loss's mean, the
# gradients' batch sums, the global norm) in another order
TOL = {"rtol": 1e-5, "atol": 1e-7}
OPT = adamw.AdamWConfig(total_steps=40, warmup_steps=4)
J_OPT = j_adamw.AdamWConfig(total_steps=40, warmup_steps=4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **(tol or TOL))


def _trees_close(port_tree, jax_tree, **tol):
    got = tr.leaves_with_paths(train_state_to_numpy(port_tree))
    want = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert [tr.key_of(p) for p, _ in got] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
        for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == np.asarray(b).dtype, path
        _close(a, b, err_msg=str(path), **(tol or TOL))


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _random_tree(seed=0):
    """A tree of the shapes the substrate meets: nested dicts, a list, a
    bf16 leaf and a 0-d leaf."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": f(5, 7), "mlp": [{"w": f(7, 3), "b": f(3)},
                                  {"w": f(3, 1), "b": f(1)}],
            "a_scalar": f(), "emb": f(11, 4).astype(jnp.bfloat16)}


# ---------------------------------------------------------------- AdamW

def test_schedule_matches_jax():
    cfg = adamw.AdamWConfig(warmup_steps=100, total_steps=10_000)
    j_cfg = j_adamw.AdamWConfig(warmup_steps=100, total_steps=10_000)
    for step in (0, 1, 7, 99, 100, 101, 2_500, 5_000, 9_999, 10_000, 12_000):
        got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        want = j_adamw.schedule(j_cfg, jnp.int32(step))
        # f32 cos of two libraries: an ulp or two
        _close(got, want, rtol=2e-7, atol=0)
        _close(adamw.schedule(cfg, step), want, rtol=2e-7, atol=0)


def test_leaf_order_is_jax_tree_order():
    tree = _random_tree()
    got = [tr.key_of(p) for p, _ in tr.leaves_with_paths(tree)]
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert got == want
    assert tr.unflatten(tree, tr.leaves(tree))["mlp"][1]["b"] is \
        tree["mlp"][1]["b"]
    with pytest.raises(ValueError, match="fewer"):
        tr.unflatten(tree, tr.leaves(tree)[:-1])
    with pytest.raises(ValueError, match="trees differ"):
        tr.map_tree(lambda a, b: a, tree, {"w": 1})


def test_apply_updates_matches_jax():
    """Three AdamW steps on a random tree with a bf16 leaf, gradients
    large enough for the clip to bind on the first."""
    params = _random_tree(0)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = j_adamw.init_state(j_params)
    p = tr.map_tree(lambda a: _t(a.view(np.int16)).view(torch.bfloat16)
                    if a.dtype == jnp.bfloat16 else _t(a), params)
    state = adamw.init_state(p)
    assert state["m"]["emb"].dtype == torch.float32
    for i in range(3):
        g = _random_tree(10 + i)
        scale = 3.0 if i == 0 else 0.05
        g = jax.tree.map(lambda x: (np.asarray(x, np.float32) * scale)
                         .astype(x.dtype), g)
        j_params, j_state, j_m = j_adamw.apply_updates(
            J_OPT, j_params, jax.tree.map(jnp.asarray, g), j_state)
        tg = tr.map_tree(lambda a: _t(a.view(np.int16)).view(torch.bfloat16)
                         if a.dtype == jnp.bfloat16 else _t(a), g)
        p, state, m = adamw.apply_updates(OPT, p, tg, state)
        _close(m["grad_norm"], j_m["grad_norm"], rtol=1e-6, atol=0)
        _close(m["lr"], j_m["lr"], rtol=2e-7, atol=0)
        assert int(state["step"]) == int(j_state["step"]) == i + 1
        _trees_close({"p": p, "m": state["m"], "v": state["v"]},
                     {"p": j_params, "m": j_state["m"], "v": j_state["v"]},
                     rtol=1e-6, atol=1e-9)
    assert float(j_m["grad_norm"]) < 1.0 < float(
        adamw.global_norm(tr.map_tree(lambda a: a * 60, tg)))


# ------------------------------------------------------- DeepFM train step

@pytest.fixture(scope="module")
def deepfm_cell():
    """The REDUCED train cell in both packages, from one JAX-drawn state
    with non-zero first-order weights."""
    j_spec, spec = j_get_arch("deepfm"), get_arch("deepfm")
    j_bundle = j_steps.build_bundle(j_spec, "train_batch", reduced=True,
                                    opt_cfg=J_OPT)
    bundle = steps.build_bundle(spec, "train_batch", reduced=True,
                                device="cpu", opt_cfg=OPT)
    params = dict(j_bundle.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    params["lin_table"] = jnp.asarray(rng.standard_normal(
        params["lin_table"].shape).astype(np.float32) * 0.1)
    j_state = j_bundle.make_state(params)
    return j_bundle, bundle, jax.tree.map(np.asarray, j_state)


def test_loss_fn_matches_jax(deepfm_cell):
    j_bundle, bundle, host = deepfm_cell
    batch = bundle.make_batch(3)
    j_batch = j_bundle.make_batch(3)
    for k in j_batch:
        np.testing.assert_array_equal(batch[k].numpy(), j_batch[k])
    state = train_state_from_jax(host, "cpu")
    loss, aux = deepfm.loss_fn(bundle.cfg, state["params"], batch)
    j_loss, _ = j_deepfm.loss_fn(j_bundle.cfg, host["params"],
                                 jax.tree.map(jnp.asarray, j_batch))
    assert aux["loss"] is loss and loss.dtype == torch.float32
    _close(loss, j_loss, rtol=1e-6, atol=0)
    # the stable form at large logits: no overflow, the JAX values
    x = torch.tensor([-200.0, -30.0, 0.0, 30.0, 200.0])
    y = torch.tensor([1, 0, 1, 1, 0])
    want = jnp.maximum(jnp.asarray(x.numpy()), 0) - jnp.asarray(
        x.numpy()) * jnp.asarray(y.numpy(), jnp.float32) + jnp.log1p(
        jnp.exp(-jnp.abs(jnp.asarray(x.numpy()))))
    got = (torch.maximum(x, torch.zeros_like(x)) - x * y.float()
           + torch.log1p(torch.exp(-x.abs())))
    _close(got, want, rtol=1e-7, atol=0)


@pytest.mark.parametrize("route,microbatches", [("bundle", 1),
                                                ("train_wrap", 2)])
def test_train_step_matches_jax_over_5_steps(deepfm_cell, route,
                                             microbatches):
    """Five steps from one state on the same batches: loss, grad_norm, lr
    and every leaf of the state.  microbatches 2 through ``_train_wrap``
    (the recsys bundle is built without microbatches in both packages)."""
    j_bundle, bundle, host = deepfm_cell
    if route == "bundle":
        j_fn, fn = jax.jit(j_bundle.fn), bundle.fn
    else:
        j_fn = jax.jit(j_steps._train_wrap(
            lambda p, b: j_deepfm.loss_fn(j_bundle.cfg, p, b), J_OPT,
            microbatches))
        fn = steps._train_wrap(
            lambda p, b: deepfm.loss_fn(bundle.cfg, p, b), OPT, microbatches)
    j_state = jax.tree.map(jnp.asarray, host)
    state = train_state_from_jax(host, "cpu")
    for i in range(5):
        state, m = fn(state, bundle.make_batch(i))
        j_state, j_m = j_fn(j_state, j_bundle.make_batch(i))
        _close(m["loss"], j_m["loss"], rtol=1e-6, atol=0)
        _close(m["grad_norm"], j_m["grad_norm"], rtol=1e-5, atol=0)
        _close(m["lr"], j_m["lr"], rtol=2e-7, atol=0)
    _trees_close(state, j_state)
    assert int(state["opt"]["step"]) == 5


def test_microbatches_split_the_batch_and_average(deepfm_cell):
    """microbatches 2 against 1 on the same batch: the mean of the two
    halves' gradients is the whole batch's gradient, up to f32 order."""
    j_bundle, bundle, host = deepfm_cell
    one = steps._train_wrap(lambda p, b: deepfm.loss_fn(bundle.cfg, p, b),
                            OPT, 1)
    two = steps._train_wrap(lambda p, b: deepfm.loss_fn(bundle.cfg, p, b),
                            OPT, 2)
    batch = bundle.make_batch(7)
    s1, m1 = one(train_state_from_jax(host, "cpu"), batch)
    s2, m2 = two(train_state_from_jax(host, "cpu"), batch)
    _close(m2["loss"], m1["loss"], rtol=1e-6, atol=0)
    _close(m2["grad_norm"], m1["grad_norm"], rtol=1e-5, atol=0)
    assert steps.build_bundle(get_arch("deepfm"), "train_batch",
                              reduced=True, device="cpu", microbatches=8
                              ).step_kind == "train"


def test_table_gradient_is_dense_and_decay_moves_every_row(deepfm_cell):
    """A lazy update would leave the rows the batch did not touch: AdamW's
    weight decay moves them all, as in the JAX package."""
    _, bundle, host = deepfm_cell
    state = train_state_from_jax(host, "cpu")
    table0 = state["params"]["table"].clone()
    batch = bundle.make_batch(0)
    new, _ = bundle.fn(state, batch)
    flat = (batch["sparse"] + deepfm.field_offsets(bundle.cfg)).reshape(-1)
    untouched = torch.ones(table0.shape[0], dtype=torch.bool)
    untouched[flat.long()] = False
    assert untouched.any()
    moved = new["params"]["table"] != table0
    assert bool(moved[untouched].all())
    assert torch.equal(state["params"]["table"], table0)   # functional


# ---------------------------------------------------------- compression

def test_compress_bf16_is_bitwise_jax():
    g = _random_tree(3)
    g = {k: v for k, v in g.items() if k != "emb"}
    g["big"] = (np.random.default_rng(4).standard_normal(1000) * 1e4).astype(
        np.float32)
    got = train_state_to_numpy(comp.compress_bf16(tr.map_tree(_t, g)))
    want = j_comp.compress_bf16(jax.tree.map(jnp.asarray, g))
    for a, b in zip(tr.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_compress_topk_with_error_feedback_matches_jax():
    """Three rounds of top-k with the error feedback carried: the sent
    values and the residual bitwise JAX's, ties at the threshold kept
    (more than k sent), and sent + residual == g + feedback exactly."""
    rng = np.random.default_rng(5)
    g0 = {"a": rng.standard_normal(256).astype(np.float32),
          "t": np.repeat(rng.standard_normal(6), 10).astype(np.float32)
          .reshape(6, 10),
          "one": rng.standard_normal(3).astype(np.float32)}
    ef, j_ef = comp.init_error_feedback(tr.map_tree(_t, g0)), \
        j_comp.init_error_feedback(jax.tree.map(jnp.asarray, g0))
    for i in range(3):
        g = jax.tree.map(lambda x: (x * (1 + i)).astype(np.float32), g0)
        tg = tr.map_tree(_t, g)
        before = tr.map_tree(lambda a, e: a.float() + e, tg, ef)
        sent, ef = comp.compress_topk(tg, ef, k_frac=0.25)
        j_sent, j_ef = j_comp.compress_topk(jax.tree.map(jnp.asarray, g),
                                            j_ef, k_frac=0.25)
        for a, b in zip(tr.leaves(sent), jax.tree.leaves(j_sent)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tr.leaves(ef), jax.tree.leaves(j_ef)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for s, e, want in zip(tr.leaves(sent), tr.leaves(ef),
                              tr.leaves(before)):
            assert torch.equal(s + e, want)
        if i == 0:   # k = 15 of 60: the threshold's tie of 10 all sent
            assert int((sent["t"] != 0).sum()) == 20
            assert int((sent["one"] != 0).sum()) == 1    # k = max(1, 0)
    for method in ("none", "bf16", "topk"):
        assert comp.wire_bytes(tr.map_tree(_t, g0), method, 0.1) == \
            j_comp.wire_bytes(g0, method, 0.1)
    with pytest.raises(ValueError):
        comp.wire_bytes(tr.map_tree(_t, g0), "zstd")


@pytest.mark.parametrize("method", ["none", "bf16", "topk"])
def test_compressed_train_step_matches_jax(method):
    """The JAX substrate's regression problem, 20 steps of each method:
    the losses agree and fall."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    y = x @ rng.standard_normal(8).astype(np.float32)

    def j_loss(params, batch):
        return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {}

    def loss(params, batch):
        return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {}

    cfg = dict(lr=0.05, weight_decay=0.0, warmup_steps=0)
    j_make, j_step = j_trainer.make_compressed_train_step(
        j_loss, j_adamw.AdamWConfig(**cfg), method, k_frac=0.25)
    make, step = make_compressed_train_step(
        loss, adamw.AdamWConfig(**cfg), method, k_frac=0.25)
    j_state = j_make({"w": jnp.zeros(8, jnp.float32)})
    state = make({"w": torch.zeros(8)})
    j_step = jax.jit(j_step)
    losses = []
    for _ in range(20):
        j_state, j_m = j_step(j_state, {"x": jnp.asarray(x),
                                        "y": jnp.asarray(y)})
        state, m = step(state, {"x": _t(x), "y": _t(y)})
        _close(m["loss"], j_m["loss"], rtol=1e-4, atol=1e-6)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.5 * losses[0]
    assert ("ef" in state) == (method == "topk")


# ---------------------------------------------------------- checkpoints

def _bf16_state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.tensor([1.5, -2.25, 3.0, 0.1],
                                         dtype=torch.bfloat16),
                       "mlp": [{"w": torch.ones(2)}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoints_cross_both_ways(tmp_path):
    """The port writes and JAX restores; JAX writes and the port restores:
    every leaf bitwise, a bf16 leaf and a 0-d int32 included."""
    st = _bf16_state()
    host = train_state_to_numpy(st)
    mgr = CheckpointManager(str(tmp_path / "port"), keep=2)
    mgr.save(10, st)
    assert mgr.saves[0]["step"] == 10 and mgr.saves[0]["bytes"] == 48 + 8 + 8 + 4
    j_restored, step = JCheckpointManager(str(tmp_path / "port")).restore(host)
    assert step == 10
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(j_restored)):
        assert str(a.dtype) == str(b.dtype)
        np.testing.assert_array_equal(_bits(a), _bits(b))

    JCheckpointManager(str(tmp_path / "jax")).save(3, jax.tree.map(
        jnp.asarray, host))
    like = tr.map_tree(torch.zeros_like, st)
    restored, step = CheckpointManager(str(tmp_path / "jax")).restore(like)
    assert step == 3
    for a, b in zip(tr.leaves(restored), tr.leaves(st)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        CheckpointManager(str(tmp_path / "jax")).restore(
            {**like, "opt": {"step": torch.zeros(2, dtype=torch.int32)}})


def test_checkpoint_keep_latest_and_partial_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _bf16_state())
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    os.makedirs(tmp_path / "step_9.tmp")        # a save cut mid-write
    assert mgr.latest_step() == 4
    assert CheckpointManager(str(tmp_path / "none")).restore(
        _bf16_state()) == (None, None)


def test_async_save_writes_the_snapshot_not_later_updates(tmp_path):
    """On the CPU a tensor's numpy view shares its storage: the snapshot
    copies, so an in-place update after ``save`` does not reach the file."""
    st = _bf16_state()
    want = jax.tree.map(np.copy, train_state_to_numpy(st))  # numpy views
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(5, st)
    st["params"]["w"].add_(100.0)
    st["params"]["b"].mul_(3)
    mgr.wait()
    restored, step = mgr.restore(st)
    assert step == 5
    for a, b in zip(tr.leaves(train_state_to_numpy(restored)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


# ----------------------------------------------------------------- trainer

def _trainer(bundle, tmp, **kw):
    cfg = dict(num_steps=8, ckpt_every=2, log_every=1, ckpt_dir=str(tmp))
    cfg.update(kw)
    fault = cfg.pop("fault_hook", None)
    return Trainer(bundle, TrainerConfig(**cfg), opt_cfg=OPT,
                   fault_hook=fault)


def test_trainer_matches_the_jax_trainer(deepfm_cell, tmp_path):
    """Both trainers from one state, 6 steps: the same logged losses and
    checkpoints at the same steps."""
    j_bundle, bundle, host = deepfm_cell
    t = _trainer(bundle, tmp_path / "port", num_steps=6)
    t.run(init_state=train_state_from_jax(host, "cpu"))
    jt = j_trainer.Trainer(j_bundle, j_trainer.TrainerConfig(
        num_steps=6, ckpt_every=2, log_every=1,
        ckpt_dir=str(tmp_path / "jax")), opt_cfg=J_OPT)
    jt.run(init_state=jax.tree.map(jnp.asarray, host))
    assert [m["step"] for m in t.metrics_log] == [
        m["step"] for m in jt.metrics_log] == [1, 2, 3, 4, 5, 6]
    _close([m["loss"] for m in t.metrics_log],
           [m["loss"] for m in jt.metrics_log], rtol=1e-6, atol=0)
    assert t.mgr.all_steps() == jt.mgr.all_steps() == [2, 4, 6]
    assert [s for s, _ in t.step_times] == list(range(6))


def test_trainer_survives_an_injected_fault_and_replays(deepfm_cell,
                                                        tmp_path):
    """A crash at step 4 restores step 4's checkpoint and replays; the
    final state is bitwise a clean run's (the CPU step is
    deterministic)."""
    _, bundle, _ = deepfm_cell
    crashed = {"done": False}

    def fault(step):
        if step == 4 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")

    t = _trainer(bundle, tmp_path / "f", fault_hook=fault)
    state = t.run()
    events = [m for m in t.metrics_log if m.get("event") == "restart"]
    assert len(events) == 1 and events[0]["restored_step"] == 4
    assert t.mgr.latest_step() == 8
    t2 = _trainer(bundle, tmp_path / "clean")
    clean = t2.run()
    last = [m["loss"] for m in t.metrics_log if "loss" in m][-1]
    last2 = [m["loss"] for m in t2.metrics_log if "loss" in m][-1]
    assert math.isclose(last, last2, rel_tol=1e-5)
    for a, b in zip(tr.leaves(state), tr.leaves(clean)):
        assert torch.equal(a, b)


def test_trainer_restores_on_a_non_finite_loss(deepfm_cell, tmp_path):
    _, bundle, _ = deepfm_cell
    real = bundle.fn
    hit = {"n": 0}

    def poisoned(state, batch):
        new, m = real(state, batch)
        if int(state["opt"]["step"]) == 3 and not hit["n"]:
            hit["n"] += 1
            m = dict(m, loss=torch.tensor(float("nan")))
        return new, m

    t = _trainer(bundle, tmp_path, num_steps=5)
    t._step_fn = poisoned
    t.run()
    events = [m for m in t.metrics_log if m.get("event") == "restart"]
    assert len(events) == 1 and "non-finite" in events[0]["error"]
    assert events[0]["restored_step"] == 2 and t.mgr.latest_step() == 5


def test_trainer_resumes_from_its_checkpoint(deepfm_cell, tmp_path):
    _, bundle, _ = deepfm_cell
    _trainer(bundle, tmp_path / "a", num_steps=4).run()
    t2 = _trainer(bundle, tmp_path / "a", num_steps=8)
    resumed = t2.run(resume=True)
    assert t2.mgr.latest_step() == 8
    assert [s for s, _ in t2.step_times] == [4, 5, 6, 7]
    straight = _trainer(bundle, tmp_path / "b").run()
    for a, b in zip(tr.leaves(resumed), tr.leaves(straight)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="train bundle"):
        Trainer(steps.build_bundle(get_arch("deepfm"), "serve_p99",
                                   reduced=True, device="cpu"),
                TrainerConfig(ckpt_dir=str(tmp_path / "c")))


# ------------------------------------------------------------ data pipeline

def test_prefetching_iterator_order_replay_and_error():
    it = pipeline.PrefetchingIterator(lambda step: {"v": np.full(3, step)},
                                      prefetch=3)
    got = [next(it) for _ in range(5)]
    it.close()
    assert [s for s, _ in got] == [0, 1, 2, 3, 4]
    assert all((b["v"] == s).all() for s, b in got)
    cfg, j_cfg = get_arch("deepfm").reduced, j_get_arch("deepfm").reduced
    s1 = pipeline.recsys_stream(cfg, 16, seed=7)
    first = dict(next(s1) for _ in range(4))
    s1.close()
    s2 = pipeline.recsys_stream(cfg, 16, seed=7, start_step=2)
    js = j_pipeline.recsys_stream(j_cfg, 16, seed=7, start_step=2)
    (step, b), (j_step, jb) = next(s2), next(js)
    s2.close()
    js.close()
    assert step == j_step == 2
    for k in jb:
        np.testing.assert_array_equal(b[k], first[2][k])
        np.testing.assert_array_equal(b[k], jb[k])
    lm = pipeline.lm_token_stream(get_arch("gemma3_12b").reduced, 2, 8,
                                  seed=3, start_step=1)
    j_lm = j_pipeline.lm_token_stream(j_get_arch("gemma3_12b").reduced, 2, 8,
                                      seed=3, start_step=1)
    np.testing.assert_array_equal(next(lm)[1]["tokens"],
                                  next(j_lm)[1]["tokens"])
    lm.close()
    j_lm.close()

    def boom(step):
        raise KeyError(step)

    bad = pipeline.PrefetchingIterator(boom)
    with pytest.raises(RuntimeError, match="worker failed"):
        next(bad)
    bad.close()


# ---------------------------------------------------------------- launcher

def test_train_launcher_prints_the_jax_launchers_metric_lines(
        tmp_path, monkeypatch, capsys):
    """Both launchers on DeepFM REDUCED, 12 steps, from the JAX package's
    seed-0 weights (the port's drawn from them for the comparison): the
    same metric lines (step, loss); dt is each run's own."""
    j_cfg = j_get_arch("deepfm").reduced
    j_params = jax.tree.map(np.asarray,
                            j_deepfm.init_params(j_cfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(deepfm, "init_params", lambda cfg, gen: tr.map_tree(
        lambda a: torch.from_numpy(np.array(a)).to(gen.device), j_params))
    argv = ["--arch", "deepfm", "--shape", "train_batch", "--steps", "12",
            "--ckpt-every", "6", "--reduced"]
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
        import ast
        return [ast.literal_eval(ln) for ln in text.splitlines()
                if ln.startswith("{")]

    mine, theirs = lines(port_out), lines(jax_out)
    assert [m["step"] for m in mine] == [m["step"] for m in theirs] == [10, 12]
    _close([m["loss"] for m in mine], [m["loss"] for m in theirs],
           rtol=1e-6, atol=0)
    assert seen["t"].mgr.all_steps() == [6, 12]
    assert len(seen["t"].step_times) == 12
    with pytest.raises(SystemExit, match="use launch.serve"):
        train_launcher.main(["--arch", "deepfm", "--shape", "serve_p99",
                             "--reduced", "--device", "cpu"])
