"""The three examples ported to ``repro_torch``
(``examples/train_lm_torch.py``, ``serve_lm_torch.py``,
``gnn_train_torch.py``) on the CPU at toy sizes:
each returns 0 with ``--device cpu``, raises without a card by default,
and loads no JAX in a process of its own; and each is held to its JAX
twin (``examples/train_lm.py``, ``serve_lm.py``, ``gnn_train.py``) on JAX's
weights, carried across by ``models.convert``: the LM losses of both
train bundles, the resumed run against an uninterrupted one, the served
tokens, the sampled GNN batches and the GNN losses."""

import os
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchSpec as JArchSpec
from repro.configs.base import LMShape as JLMShape
from repro.configs.base import get_arch as j_get_arch
from repro.data import pipeline as j_pipeline
from repro.graphs import csr_from_coo as j_csr_from_coo
from repro.graphs import erdos_renyi as j_erdos_renyi
from repro.graphs.sampler import NeighborSampler as JNeighborSampler
from repro.launch import steps as j_steps
from repro.models import transformer as j_tf
from repro.models.gnn import models as j_gnn
from repro.optim import adamw as j_adamw
from repro.serve.batcher import Request as JRequest
from repro.serve.batcher import Server as JServer
from repro_torch import tree as tr
from repro_torch.configs.base import ArchSpec, LMShape, get_arch
from repro_torch.launch.steps import _lm_bundle
from repro_torch.models import transformer as tf
from repro_torch.models.convert import (from_jax_params, gnn_from_jax_params,
                                        train_state_from_jax)
from repro_torch.models.gnn import models as gnn
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
CPU = torch.device("cpu")
# f32 on both sides, the same formulas, sums in another order: the LM
# losses as tests/test_torch_lm_train.py holds them, the GNN losses as
# tests/test_torch_train.py holds a step's
LM_LOSS_RTOL = 1e-6
GNN_LOSS_RTOL = 1e-5
# toy sizes: the LM twin's flags; the GNN twin's module constants
TOY_LM = ["--steps", "8", "--batch", "2", "--seq", "16"]
TOY_FULL = {"steps": 6, "ckpt_every": 3}
TOY_SAMPLED = {"n": 500, "avg_degree": 20, "steps": 3}
TWINS = ("train_lm", "serve_lm", "gnn_train")


def _twin(name: str) -> dict:
    """The twin's module namespace, its sizes cut to the toy ones."""
    ns = runpy.run_path(str(EXAMPLES / f"{name}_torch.py"))
    if name == "gnn_train":
        ns["FULL"].update(TOY_FULL)
        ns["SAMPLED"].update(TOY_SAMPLED)
    return ns


def _argv(name: str, tmp_path) -> list:
    argv = ["--device", "cpu"]
    if name == "train_lm":
        argv += TOY_LM + ["--ckpt-dir", str(tmp_path / "ckpt")]
    return argv


@pytest.mark.parametrize("name", TWINS)
def test_twin_runs_on_the_cpu(name, tmp_path, capsys):
    assert _twin(name)["main"](_argv(name, tmp_path)) == 0
    out = capsys.readouterr().out
    first = {"train_lm": "model: demo-10m params=6.0M",
             "serve_lm": "served 10 requests, ",
             "gnn_train": "gcn full-batch: loss "}[name]
    assert out.startswith(first), out
    if name == "serve_lm":
        assert "tok/s on the CPU)" in out


@pytest.mark.parametrize("name", TWINS)
def test_twin_without_a_card_raises_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device cuda runs")
    with pytest.raises(SystemExit, match="--device cpu"):
        _twin(name)["main"]([])


_NO_JAX = r"""
import runpy, sys
name, tmp = sys.argv[1], sys.argv[2]
ns = runpy.run_path(f"examples/{name}_torch.py")
argv = ["--device", "cpu"]
if name == "train_lm":
    argv += ["--steps", "4", "--batch", "2", "--seq", "16", "--ckpt-dir", tmp]
if name == "gnn_train":
    ns["FULL"].update(steps=2, ckpt_every=2)
    ns["SAMPLED"].update(n=300, steps=1)
assert ns["main"](argv) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
print("no jax")
"""


@pytest.mark.parametrize("name", TWINS)
def test_twin_loads_neither_jax_nor_the_jax_package(name, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _NO_JAX, name,
                          str(tmp_path)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("no jax")


# ------------------------------------------------------------------ train_lm

def _lm_opt(steps: int):
    kw = dict(lr=1e-3, warmup_steps=20, total_steps=steps)
    return AdamWConfig(**kw), j_adamw.AdamWConfig(**kw)


def test_train_lm_bundle_losses_match_jaxs_from_jaxs_state():
    """The twin's config and schedule (batch 2, seq 16, 8 steps) from
    JAX's seed-0 train state carried across: the port's LM train bundle
    and JAX's ``_lm_bundle`` on the same batches, 4 steps, losses within
    rtol 1e-6."""
    cfg = _twin("train_lm")["CFG"]
    j_cfg = runpy.run_path(str(EXAMPLES / "train_lm.py"))["CFG"]
    opt, j_opt = _lm_opt(8)
    b = _lm_bundle(ArchSpec("demo", "lm", cfg, cfg, "example"),
                   LMShape("train_demo", "train", 16, 2), cfg, CPU, opt, 1)
    j_b = j_steps._lm_bundle(JArchSpec("demo", "lm", j_cfg, j_cfg, "example"),
                             JLMShape("train_demo", "train", 16, 2), j_cfg,
                             j_opt)
    j_state = j_b.make_state(j_b.init_params(jax.random.PRNGKey(0)))
    state = train_state_from_jax(jax.tree.map(np.asarray, j_state), "cpu")
    j_fn = jax.jit(j_b.fn)
    losses, j_losses = [], []
    for step in range(4):
        batch, j_batch = b.make_batch(step), j_b.make_batch(step)
        np.testing.assert_array_equal(batch["tokens"].numpy(),
                                      j_batch["tokens"])
        state, m = b.fn(state, batch)
        j_state, j_m = j_fn(j_state, j_batch)
        losses.append(float(m["loss"]))
        j_losses.append(float(j_m["loss"]))
    np.testing.assert_allclose(losses, j_losses, rtol=LM_LOSS_RTOL, atol=0)
    assert losses[-1] < losses[0]


def test_train_lm_resumed_run_is_bitwise_an_uninterrupted_one(tmp_path):
    """The twin killed at step 4 and resumed from its checkpoint gives
    the losses and the final state of one uninterrupted run, bit for bit;
    the second Trainer starts at step 4."""
    seen = {}
    assert _twin("train_lm")["main"](
        _argv("train_lm", tmp_path),
        on_done=lambda t1, t2, state: seen.update(t1=t1, t2=t2,
                                                  state=state)) == 0
    t1, t2 = seen["t1"], seen["t2"]
    assert t2.mgr.all_steps() == [4, 8] and t2.step_times[0][0] == 4
    cfg = _twin("train_lm")["CFG"]
    b = _lm_bundle(ArchSpec("demo", "lm", cfg, cfg, "example"),
                   LMShape("train_demo", "train", 16, 2), cfg, CPU,
                   _lm_opt(8)[0], 1)
    clean = Trainer(b, TrainerConfig(num_steps=8, ckpt_every=50, log_every=1,
                                     ckpt_dir=str(tmp_path / "clean")))
    state = clean.run()
    want = {m["step"]: m["loss"] for m in clean.metrics_log if "loss" in m}
    got = [(m["step"], m["loss"]) for m in t1.metrics_log + t2.metrics_log
           if "loss" in m]
    assert [s for s, _ in got] == [4, 8]
    assert all(loss == want[s] for s, loss in got), (got, want)
    for a, c in zip(tr.leaves(seen["state"]), tr.leaves(state)):
        assert torch.equal(a, c)


# ------------------------------------------------------------------ serve_lm

def test_serve_lm_serves_jaxs_servers_tokens(monkeypatch):
    """JAX's example weights (``PRNGKey(0)``) carried across: the twin's
    ``Server`` over its 10 requests gives exactly JAX's ``Server``'s tokens
    on the same requests, and finishes them in the same order."""
    j_ns = runpy.run_path(str(EXAMPLES / "serve_lm.py"))
    j_cfg = j_ns["CFG"]
    j_params = j_tf.init_params(j_cfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, j_params), "cpu")
    monkeypatch.setattr(tf, "init_params", lambda cfg, gen: params)
    ns = _twin("serve_lm")
    seen = {}
    assert ns["main"](["--device", "cpu"],
                      on_done=lambda s, d, t: seen.update(done=d)) == 0
    # the JAX example's draw
    rng = np.random.default_rng(0)
    j_reqs = [JRequest(rid=i,
                       prompt=rng.integers(0, j_cfg.vocab, rng.integers(3, 9))
                       .astype(np.int32),
                       max_new_tokens=int(rng.integers(4, 12)))
              for i in range(10)]
    for r, jr in zip(ns["requests"](), j_reqs):
        assert r.rid == jr.rid and r.max_new_tokens == jr.max_new_tokens
        np.testing.assert_array_equal(r.prompt, jr.prompt)
    j_srv = JServer(j_cfg, j_params, batch_slots=4, max_len=64)
    for jr in j_reqs:
        j_srv.submit(jr)
    j_done = j_srv.run_until_drained()
    assert [r.rid for r in seen["done"]] == [r.rid for r in j_done]
    assert len(j_done) == 10
    for r, jr in zip(seen["done"], j_done):
        assert r.out == jr.out and len(r.out) == r.max_new_tokens, r.rid


# ----------------------------------------------------------------- gnn_train

def _same_bits(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, a in got.items():
        b = np.asarray(want[k])
        a = a.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_gnn_sampled_batches_are_jaxs_and_losses_within_rtol(monkeypatch):
    """The twin's sampled run, cut to 3 steps on a 500-node graph, from
    JAX's ``PRNGKey(0)`` weights carried across: each batch, its targets
    included, is the JAX example's bit for bit, and each step's loss
    within rtol 1e-5 of JAX's step on it."""
    cfg, j_cfg = get_arch("gatedgcn").reduced, j_get_arch("gatedgcn").reduced
    j_params = j_gnn.init_params(j_cfg, 16, jax.random.PRNGKey(0))
    monkeypatch.setattr(gnn, "init_params", lambda c, d, gen: (
        gnn_from_jax_params(jax.tree.map(np.asarray, j_params), "cpu")))
    seen = []
    ns = _twin("gnn_train")
    ns["sampled_minibatch"](CPU, on_step=lambda i, b, loss: seen.append(
        (b, loss)))
    assert len(seen) == TOY_SAMPLED["steps"]

    n = TOY_SAMPLED["n"]
    src, dst = j_erdos_renyi(n, avg_degree=TOY_SAMPLED["avg_degree"], seed=0)
    indptr, indices = j_csr_from_coo(src, dst, n)
    stream = j_pipeline.graph_minibatch_stream(
        JNeighborSampler(indptr, indices), batch_nodes=32, fanouts=(5, 3),
        n_pad=1024, e_pad=1024, d_feat=16, seed=0)
    ocfg = j_adamw.AdamWConfig(lr=3e-3)

    @jax.jit
    def train_step(params, opt, batch):
        def loss_fn(p):
            return j_gnn.loss_fn(j_cfg, p, batch)
        (l, _), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        params, opt, _ = j_adamw.apply_updates(ocfg, params, g, opt)
        return params, opt, l

    rng = np.random.default_rng(0)
    params, opt = j_params, j_adamw.init_state(j_params)
    try:
        for batch, loss in seen:
            _, jb = next(stream)
            jb = {k: v for k, v in jb.items() if k != "global_ids"}
            jb["targets"] = rng.standard_normal(
                (jb["node_feats"].shape[0], cfg.d_out)).astype(np.float32)
            _same_bits(batch, jb)
            params, opt, l = train_step(params, opt, {
                k: jnp.asarray(v) for k, v in jb.items()})
            np.testing.assert_allclose(loss, float(l), rtol=GNN_LOSS_RTOL,
                                       atol=0)
    finally:
        stream.close()


def test_gnn_full_batch_first_step_loss_within_rtol_of_jaxs():
    """The twin's full-batch bundle (``gcn_cora`` reduced on
    ``full_graph_sm``) from JAX's bundle's seed-0 state: the Trainer's first
    batch bitwise JAX's and the first step's loss within rtol 1e-5."""
    b = _twin("gnn_train")["full_batch_bundle"](CPU)
    j_b = j_steps.build_bundle(j_get_arch("gcn_cora"), "full_graph_sm",
                               reduced=True)
    j_state = j_b.make_state(j_b.init_params(jax.random.PRNGKey(0)))
    state = train_state_from_jax(jax.tree.map(np.asarray, j_state), "cpu")
    batch, j_batch = b.make_batch(0), j_b.make_batch(0)
    _same_bits(batch, j_batch)
    _, m = b.fn(state, batch)
    _, j_m = jax.jit(j_b.fn)(j_state, j_batch)
    np.testing.assert_allclose(float(m["loss"]), float(j_m["loss"]),
                               rtol=GNN_LOSS_RTOL, atol=0)
