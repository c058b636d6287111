"""The port's LM train step on the CPU against the JAX package: the
chunked online-softmax scan of ``chunked_attention`` and its flash-train
route (forward and gradients), ``cross_entropy``, ``layer_norm``,
``forward``, ``lm_loss`` and its gradients under each ``remat``, the LM
train bundle over 5 steps (microbatches 1 and 2), the buffer-reusing
AdamW update, LM checkpoints in both directions, the trainer's fault
replay, the train launcher and a trained state's prefill.  gemma3's
REDUCED config (f32, 6 layers, windows 16 and 0) with ``attn_chunk`` 8 and
loss chunks of 8 over 32 positions, so every scan has several chunks;
weights cross from JAX by ``models.convert``."""

import ast
import collections
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import get_arch as j_get_arch
from repro.launch import steps as j_steps
from repro.launch import train as j_train_launcher
from repro.layers import core as j_core
from repro.models import transformer as j_tf
from repro.optim import adamw as j_adamw
from repro.train import trainer as j_trainer
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch import tree as tr
from repro_torch.configs import get_arch
from repro_torch.launch import steps
from repro_torch.launch import train as train_launcher
from repro_torch.layers import core
from repro_torch.models import transformer as tf
from repro_torch.models.convert import (train_state_from_jax,
                                        train_state_to_numpy)
from repro_torch.optim import adamw
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

# f32 on both sides, the same formulas, products and sums in another
# order (the attention's, the heads', the gradients' batch sums).  The
# attention's values are O(1); a query that sees one key has a dq of 0,
# which both read as rounding noise of about 1e-6 (test_torch_decode.py's
# TOL)
ATTN_TOL = {"rtol": 1e-5, "atol": 1e-5}
LOSS_TOL = {"rtol": 1e-6, "atol": 0}
# gradients and train states leaf by leaf: the relative L2 error
# |got - want| / |want| of each leaf within test_torch_train.py's rtol
# (elementwise, a gradient element near 0 reads any relative error; the
# correct port reads at most 2.6e-6 here)
REL_L2 = 1e-5
OPT = adamw.AdamWConfig(total_steps=40, warmup_steps=4)
J_OPT = j_adamw.AdamWConfig(total_steps=40, warmup_steps=4)
CHUNK = 8
SEQ, BATCH = 32, 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


def _leaves_close(port_leaves, jax_tree):
    """Each leaf within REL_L2 of JAX's, an integer leaf equal."""
    want = jax.tree.leaves(jax_tree)
    assert len(port_leaves) == len(want)
    for i, (a, b) in enumerate(zip(port_leaves, want)):
        a, b = a.detach().numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, i
        err = np.linalg.norm((a - b).astype(np.float64))
        assert err <= REL_L2 * np.linalg.norm(b.astype(np.float64)), (
            i, err, np.linalg.norm(b))


@pytest.fixture(scope="module")
def cell():
    """The cut config in both packages, JAX's seed-0 weights and a batch
    of (2, 33) tokens, with JAX's loss and gradients computed once."""
    j_spec, spec = j_get_arch("gemma3_12b"), get_arch("gemma3_12b")
    j_cfg = dataclasses.replace(j_spec.reduced, attn_chunk=CHUNK)
    cfg = dataclasses.replace(spec.reduced, attn_chunk=CHUNK)
    j_params = jax.jit(j_tf.init_params, static_argnums=0)(
        j_cfg, jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, j_params)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    (j_loss, j_aux), j_grads = jax.jit(jax.value_and_grad(
        lambda p, t: j_tf.lm_loss(j_cfg, p, t, loss_chunk=CHUNK),
        has_aux=True))(j_params, jnp.asarray(tokens))
    return {"j_spec": j_spec, "spec": spec, "j_cfg": j_cfg, "cfg": cfg,
            "j_params": j_params, "host": host, "tokens": tokens,
            "j_loss": j_loss, "j_aux": j_aux, "j_grads": j_grads}


def _params(cell):
    return tr.map_tree(_t, cell["host"])


def _qkv(seed, b=2, hq=4, hkv=2, sq=24, skv=24, dh=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, dh)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, dh)).astype(np.float32))


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("q_offset,kv_len,window", [
    (8, 32, 0),                      # shared offset and length over a cache
    (8, 32, 5),
    (0, 20, 16),                     # keys past the valid length
    ([0, 8], [24, 32], 0),           # each sequence at its own depth
    ([3, 8], [27, 32], 6),
    ([0, 0], [0, 32], 0),            # a sequence that sees no key
    (0, None, 7)])                   # the train route's forward
def test_chunked_attention_scan_routes_match_jax(q_offset, kv_len, window):
    """24 queries over 32 keys in chunks of 8 (the scan), against JAX's
    routing of the same call."""
    q, k, v = _qkv(len(str(q_offset)) + window, skv=32)

    def arg(x, lib):
        if isinstance(x, list):
            return (jnp.asarray(x, jnp.int32) if lib == "jax"
                    else torch.tensor(x, dtype=torch.int32))
        return x

    want = j_core.chunked_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, window=window,
        chunk=CHUNK, q_offset=arg(q_offset, "jax"), kv_len=arg(kv_len, "jax"))
    got = core.chunked_attention(
        _t(q), _t(k), _t(v), causal=True, window=window, chunk=CHUNK,
        q_offset=arg(q_offset, "torch"), kv_len=arg(kv_len, "torch"))
    _close(got, want, **ATTN_TOL)
    if kv_len == [0, 32]:
        assert not got[0].any()


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (True, 16),
                                           (False, 0)])
def test_flash_train_and_its_gradients_match_jax_vjp(causal, window):
    """The train route (no cache) forward and its q, k, v gradients against
    ``jax.vjp`` of JAX's ``_make_flash_train``; ``torch.func.vjp`` goes
    through the Function and gives autograd's gradients bitwise."""
    q, k, v = _qkv(window, sq=32, skv=32)
    do = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a, b, c: j_core.chunked_attention(
        a, b, c, causal=causal, window=window, chunk=CHUNK),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = core.chunked_attention(tq, tk, tv, causal=causal, window=window,
                                 chunk=CHUNK)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    _close(out.detach(), out_j, **ATTN_TOL)
    for g, w in zip(grads, want):
        _close(g, w, **ATTN_TOL)
    _, f_vjp = torch.func.vjp(lambda a, b, c: core.chunked_attention(
        a, b, c, causal=causal, window=window, chunk=CHUNK),
        _t(q), _t(k), _t(v))
    for a, b in zip(f_vjp(_t(do)), grads):
        assert torch.equal(a, b)


def test_flash_train_keeps_o_s_dh_residuals():
    """What the train route saves for its backward is q, k, v, out and the
    (B, Hkv, G, S, 1) statistics: no (S x chunk) probability."""
    q, k, v = (_t(x).requires_grad_() for x in _qkv(0, sq=64, skv=64))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        core.chunked_attention(q, k, v, chunk=CHUNK)
    stats = 2 * 2 * 2 * 64    # b * hkv * group * s for each of m and l
    assert sorted(saved) == sorted([q.numel(), k.numel(), v.numel(),
                                    q.numel(), stats, stats])


def test_cross_entropy_and_layer_norm_match_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
    _close(core.cross_entropy(_t(logits), _t(labels)),
           j_core.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)),
           **LOSS_TOL)
    _close(core.cross_entropy(_t(logits), _t(labels), _t(mask)),
           j_core.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(mask)), **LOSS_TOL)
    zero = np.zeros_like(mask)            # the divisor's floor of 1
    assert float(core.cross_entropy(_t(logits), _t(labels), _t(zero))) == 0
    x = (rng.standard_normal((4, 5, 24)) * 3 + 1).astype(np.float32)
    w, b = rng.standard_normal(24).astype(np.float32), rng.standard_normal(
        24).astype(np.float32)
    _close(core.layer_norm(_t(x), _t(w), _t(b)),
           j_core.layer_norm(*map(jnp.asarray, (x, w, b))), **ATTN_TOL)
    xb = _t(x).to(torch.bfloat16)
    assert core.layer_norm(xb, _t(w), _t(b)).dtype == torch.bfloat16


# ---------------------------------------------------------------- model

def test_forward_logits_match_jax(cell):
    tokens = cell["tokens"][:, :-1]
    want, _ = jax.jit(lambda p, t: j_tf.forward(cell["j_cfg"], p, t))(
        cell["j_params"], jnp.asarray(tokens))
    with torch.no_grad():
        got, aux = tf.forward(cell["cfg"], _params(cell), _t(tokens))
    assert got.shape == (BATCH, SEQ, cell["cfg"].vocab)
    assert float(aux["lb_loss"]) == 0
    _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def remat_grads(cell):
    """The port's loss and gradients under each remat policy."""
    out = {}
    for remat in ("none", "block", "dots"):
        cfg = dataclasses.replace(cell["cfg"], remat=remat)
        grad_fn = steps.autograd_grads(
            lambda p, b, c=cfg: tf.lm_loss(c, p, b, loss_chunk=CHUNK))
        out[remat] = grad_fn(_params(cell), _t(cell["tokens"]))
    return out


@pytest.mark.parametrize("remat", ["none", "block", "dots"])
def test_lm_loss_and_gradients_match_jax(cell, remat_grads, remat):
    """Every gradient leaf against JAX's (remat ``block``, the config's),
    and bitwise the same under every policy: remat only recomputes."""
    grads, (loss, aux) = remat_grads[remat]
    _close(loss, cell["j_loss"], **LOSS_TOL)
    _close(aux["ce"], cell["j_aux"]["ce"], **LOSS_TOL)
    assert float(aux["lb_loss"]) == float(cell["j_aux"]["lb_loss"]) == 0
    _leaves_close(grads, cell["j_grads"])
    base, (base_loss, _) = remat_grads["none"]
    assert torch.equal(loss, base_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, base))


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(cfg, tree, tokens) -> dict:
    """(``mm``, ``bmm``) calls of the backward of ``lm_loss`` under each
    remat policy."""
    counts = {}
    for remat in ("none", "block", "dots"):
        cfg_r = dataclasses.replace(cfg, remat=remat)
        leaves = [p.detach().requires_grad_() for p in tr.leaves(tree)]
        loss, _ = tf.lm_loss(cfg_r, tr.unflatten(tree, leaves), tokens,
                             loss_chunk=CHUNK)
        mode = _OpCount()
        with mode:
            torch.autograd.grad(loss, leaves)
        counts[remat] = (mode.counts[torch.ops.aten.mm.default],
                         mode.counts[torch.ops.aten.bmm.default])
    return counts


def test_remat_policies_recompute_what_jax_recomputes(cell):
    """The backward's products: ``block`` recomputes the blocks' weight
    products (``mm``) and the attention's (``bmm``); ``dots`` keeps the
    weight products, as ``dots_with_no_batch_dims_saveable``, and
    recomputes only the attention's; ``none`` recomputes neither.  On an
    MoE config (llama4's REDUCED: a dense block, then an MoE block with a
    shared expert) ``dots`` also keeps the router's and the shared
    expert's products (2-D) and recomputes the experts' (batched over the
    experts, as JAX's einsum, which that policy does not save)."""
    counts = _backward_products(cell["cfg"], _params(cell),
                                _t(cell["tokens"]))
    layers, chunks = cell["cfg"].n_layers, SEQ // CHUNK
    mm, bmm = counts["none"]
    # the forward of each attention is 2 products a KV chunk; each block
    # recomputes its weight products but the last (w_down's output is
    # not saved for anything)
    assert counts["block"] == (mm + 6 * layers, bmm + 2 * chunks * layers)
    assert counts["dots"] == (mm, bmm + 2 * chunks * layers)

    cfg = dataclasses.replace(get_arch("llama4_maverick_400b_a17b").reduced,
                              attn_chunk=CHUNK)
    assert [sp.moe for sp in cfg.pattern] == [False, True]
    counts = _backward_products(
        cfg, tf.init_tree(cfg, torch.Generator().manual_seed(0)),
        _t(cell["tokens"]))
    mm, bmm = counts["none"]
    # the MoE block recomputes all 8 of its 2-D products (q, k, v, o, the
    # router, the shared expert's three: the balance loss comes after
    # them) and the experts' 3 batched ones
    attn = 2 * chunks * cfg.n_layers
    assert counts["block"] == (mm + 6 + 8, bmm + attn + 3)
    assert counts["dots"] == (mm, bmm + attn + 3)


# ----------------------------------------------------------- train step

def _bundles(cell, microbatches):
    j_spec = dataclasses.replace(cell["j_spec"], reduced=cell["j_cfg"])
    spec = dataclasses.replace(cell["spec"], reduced=cell["cfg"])
    j_b = j_steps.build_bundle(j_spec, "train_4k", reduced=True,
                               opt_cfg=J_OPT, microbatches=microbatches)
    b = steps.build_bundle(spec, "train_4k", reduced=True, device="cpu",
                           opt_cfg=OPT, microbatches=microbatches)
    return j_b, b


@pytest.fixture(scope="module")
def trained(cell):
    """Five steps of both train bundles from one state, microbatches 1
    and 2: the metrics of each step and the final states."""
    out = {}
    for mb in (1, 2):
        j_b, b = _bundles(cell, mb)
        assert b.step_kind == j_b.step_kind == "train"
        j_state = j_b.make_state(cell["j_params"])
        state = train_state_from_jax(jax.tree.map(np.asarray, j_state),
                                     "cpu")
        j_fn = jax.jit(j_b.fn)
        rows = []
        for i in range(5):
            batch, j_batch = b.make_batch(i), j_b.make_batch(i)
            np.testing.assert_array_equal(batch["tokens"].numpy(),
                                          j_batch["tokens"])
            state, m = b.fn(state, batch)
            j_state, j_m = j_fn(j_state, j_batch)
            rows.append((m, j_m))
        out[mb] = (state, j_state, rows)
        out["bundles", mb] = (j_b, b, j_fn)
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_bundle_matches_jax_over_5_steps(trained, microbatches):
    state, j_state, rows = trained[microbatches]
    for m, j_m in rows:
        _close(m["loss"], j_m["loss"], rtol=1e-6, atol=0)
        _close(m["grad_norm"], j_m["grad_norm"], rtol=1e-5, atol=0)
        _close(m["lr"], j_m["lr"], rtol=2e-7, atol=0)
    _leaves_close(tr.leaves(state), j_state)
    assert int(state["opt"]["step"]) == 5


def test_microbatches_split_the_lm_batch_and_average(trained):
    (m1, _), (m2, _) = trained[1][2][0], trained[2][2][0]
    _close(m2["loss"], m1["loss"], rtol=1e-6, atol=0)
    _close(m2["grad_norm"], m1["grad_norm"], rtol=1e-5, atol=0)


def _buffers(state) -> list:
    return [t.data_ptr() for t in tr.leaves((
        state["params"], state["opt"]["m"], state["opt"]["v"]))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_in_place_update_is_bitwise_apply_updates(cell, dtype):
    """One LM step's gradients through both updates, three times from one
    state: every leaf bitwise, the step's tensors written in place, the
    gradient list emptied."""
    cfg = dataclasses.replace(cell["cfg"], dtype=dtype)
    params = tf.init_tree(cfg, torch.Generator().manual_seed(1))
    grad_fn = steps.autograd_grads(
        lambda p, b: tf.lm_loss(cfg, p, b, loss_chunk=CHUNK))
    state = steps._make_state(params)
    twin = tr.map_tree(torch.clone, state)
    for i in range(3):
        grads, _ = grad_fn(state["params"], _t(cell["tokens"]))
        grads = [g * (40.0 if i == 0 else 1.0) for g in grads]  # clip binds
        new_p, new_opt, m = adamw.apply_updates(
            OPT, twin["params"], tr.unflatten(params, grads), twin["opt"])
        twin = {"params": new_p, "opt": new_opt}
        ptrs = _buffers(state)
        p_, opt_, m_ = adamw.apply_updates_(OPT, state["params"], grads,
                                            state["opt"])
        assert all(g is None for g in grads)
        state = {"params": p_, "opt": opt_}
        assert _buffers(state) == ptrs
        assert torch.equal(m["grad_norm"], m_["grad_norm"])
        for a, b in zip(tr.leaves(state), tr.leaves(twin)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert float(m["grad_norm"]) > 0


# ---------------------------------------------- checkpoints and trainer

def test_lm_checkpoints_cross_both_ways(trained, tmp_path):
    """An LM train state saved by the port restores bitwise in JAX, under
    JAX's keys, and JAX's restores bitwise in the port."""
    state, j_state, _ = trained[1]
    mgr = CheckpointManager(str(tmp_path / "port"), keep=1)
    mgr.save(5, state)
    host = train_state_to_numpy(state)
    restored, step = JCheckpointManager(str(tmp_path / "port")).restore(host)
    assert step == 5
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(a, b)
    with open(tmp_path / "port" / "step_5" / "manifest.json") as f:
        keys = [e["key"] for e in json.load(f)["leaves"]]
    assert "params/blocks/0/attn/wq" in keys and "opt/m/unembed" in keys
    assert keys == ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                             for k in p) for p, _ in
                    jax.tree_util.tree_flatten_with_path(host)[0]]
    JCheckpointManager(str(tmp_path / "jax")).save(5, j_state)
    back, step = CheckpointManager(str(tmp_path / "jax")).restore(
        tr.map_tree(torch.zeros_like, state))
    assert step == 5
    for a, b in zip(tr.leaves(back), jax.tree.leaves(j_state)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_lm_trainer_fault_replay_matches_jax(cell, trained, tmp_path):
    """A crash at step 4 of 6 (checkpoints every 2) in both trainers from
    one state: one restart from step 4, the same logged losses, the same
    final state; the port's final state is bitwise a clean run's."""
    j_b, b, j_fn = trained["bundles", 1]

    def fault_once():
        fired = {"n": 0}

        def fault(step):
            if step == 4 and not fired["n"]:
                fired["n"] += 1
                raise RuntimeError("injected node failure")
        return fault

    kw = dict(num_steps=6, ckpt_every=2, log_every=1)
    init = train_state_from_jax(jax.tree.map(np.asarray, j_b.make_state(
        cell["j_params"])), "cpu")
    t = Trainer(b, TrainerConfig(ckpt_dir=str(tmp_path / "port"), **kw),
                opt_cfg=OPT, fault_hook=fault_once())
    state = t.run(init_state=tr.map_tree(torch.clone, init))
    jt = j_trainer.Trainer(j_b, j_trainer.TrainerConfig(
        ckpt_dir=str(tmp_path / "jax"), **kw), opt_cfg=J_OPT,
        fault_hook=fault_once())
    jt._step_fn = j_fn                   # the step compiled once already
    j_state = jt.run(init_state=j_b.make_state(cell["j_params"]))
    events = [m for m in t.metrics_log if m.get("event") == "restart"]
    j_events = [m for m in jt.metrics_log if m.get("event") == "restart"]
    assert [e["restored_step"] for e in events] == [
        e["restored_step"] for e in j_events] == [4]
    losses = [m["loss"] for m in t.metrics_log if "loss" in m]
    j_losses = [m["loss"] for m in jt.metrics_log if "loss" in m]
    assert [m["step"] for m in t.metrics_log if "loss" in m] == [
        m["step"] for m in jt.metrics_log if "loss" in m] == [1, 2, 3, 4, 5, 6]
    _close(losses, j_losses, rtol=1e-6, atol=0)
    _leaves_close(tr.leaves(state), j_state)
    clean = Trainer(b, TrainerConfig(ckpt_dir=str(tmp_path / "clean"), **kw),
                    opt_cfg=OPT).run(init_state=init)
    for a, c in zip(tr.leaves(state), tr.leaves(clean)):
        assert torch.equal(a, c)


def test_lm_train_launcher_prints_the_jax_launchers_metric_lines(
        cell, tmp_path, monkeypatch, capsys):
    """``--arch gemma3_12b --shape train_4k --reduced`` through both
    launchers, 4 steps from JAX's seed-0 weights (``attn_chunk`` draws
    nothing, so the cell's): the same metric lines (step, loss); dt is
    each run's own."""
    host = cell["host"]
    monkeypatch.setattr(tf, "init_tree", lambda cfg, gen: tr.map_tree(
        lambda a: torch.from_numpy(np.array(a)).to(gen.device), host))
    argv = ["--arch", "gemma3_12b", "--shape", "train_4k", "--steps", "4",
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
    assert [m["step"] for m in mine] == [m["step"] for m in theirs] == [4]
    _close([m["loss"] for m in mine], [m["loss"] for m in theirs],
           rtol=1e-6, atol=0)
    assert seen["t"].mgr.all_steps() == [2, 4]


def test_a_trained_state_prefills_as_jax(cell, trained):
    """The 5-step state's params serve: ``Transformer.from_tree`` over the
    state's own tensors, prefilled as JAX prefills the same params."""
    state, _, _ = trained[1]
    params = tf.Transformer.from_tree(state["params"])
    assert params.embed.data_ptr() == state["params"]["embed"].data_ptr()
    host = train_state_to_numpy(state)["params"]
    prompt = cell["tokens"][:, :20]
    want, _, _ = jax.jit(lambda p, t: j_tf.prefill(cell["j_cfg"], p, t, 24))(
        jax.tree.map(jnp.asarray, host), jnp.asarray(prompt))
    got, cache, n = tf.prefill(cell["cfg"], params, _t(prompt), 24)
    assert n == 20
    _close(got, want, rtol=1e-5, atol=1e-5)
