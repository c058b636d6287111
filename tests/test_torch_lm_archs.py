"""The four LM configs of the MoE slice (``dbrx_132b``,
``llama4_maverick_400b_a17b``, ``yi_34b``, ``qwen1_5_110b``) and the
transformer's MoE blocks, ``qkv_bias`` and ``tie_embeddings`` on the CPU
against the JAX package, f32, at the REDUCED configs with the JAX
package's weights carried across by ``models.convert``: the registry, the
bundles of every LM shape, each arch's train loss, ``lb_loss`` and every
gradient leaf, its prefill logits and cache, its decode steps, nonzero
q/k/v biases (a bias dropped must fail), tied embeddings, the MoE train
state's checkpoint in both directions, and both launchers (the serve
launcher's tokens against the JAX launcher's)."""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.launch import serve as j_serve_launcher
from repro.launch import steps as j_steps
from repro.models import transformer as j_tf
from repro.serve.batcher import Server as JServer
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch import tree as tr
from repro_torch.configs import base
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import steps
from repro_torch.launch import train as train_launcher
from repro_torch.layers import core
from repro_torch.models import transformer as tf
from repro_torch.models.convert import (from_jax_params, to_numpy,
                                        train_state_from_jax,
                                        train_state_to_numpy)
from repro_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

ARCHS = ("dbrx_132b", "llama4_maverick_400b_a17b", "yi_34b", "qwen1_5_110b")
LM_ARCHS = ("dbrx_132b", "llama4_maverick_400b_a17b", "gemma3_12b", "yi_34b",
            "qwen1_5_110b")
# f32 on both sides, the same formulas, products and sums in another order
# (test_torch_transformer.py's TOL)
TOL = {"atol": 1e-5, "rtol": 1e-5}
# the loss, and each gradient leaf's relative L2 error
# (test_torch_lm_train.py's)
LOSS_TOL = {"rtol": 1e-6, "atol": 0}
REL_L2 = 1e-5
SEQ, BATCH = 32, 2
_j_init = jax.jit(j_tf.init_params, static_argnums=0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


def _leaves_close(port_leaves, jax_tree, rel=REL_L2):
    want = jax.tree.leaves(jax_tree)
    assert len(port_leaves) == len(want)
    for i, (a, b) in enumerate(zip(port_leaves, want)):
        a, b = a.detach().numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, i
        err = np.linalg.norm((a - b).astype(np.float64))
        assert err <= rel * np.linalg.norm(b.astype(np.float64)), (i, err)


def _with_biases(j_params, seed: int):
    """JAX's tree with every ``bq`` / ``bk`` / ``bv`` drawn nonzero (JAX
    initialises them to zero, which would hide a port that ignores
    them)."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        if getattr(path[-1], "key", None) in ("bq", "bk", "bv"):
            return jnp.asarray(rng.standard_normal(x.shape).astype(
                np.float32) * 0.5)
        return x
    return jax.tree_util.tree_map_with_path(draw, j_params)


_CELLS = {}


def _cell(arch: str) -> dict:
    """The arch's REDUCED config in both packages, JAX's seed-0 weights
    (qwen's biases drawn nonzero), a (2, 33) token batch and JAX's loss
    and gradients, computed once a module."""
    if arch not in _CELLS:
        j_cfg = j_base.get_arch(arch).reduced
        cfg = base.get_arch(arch).reduced
        j_params = _j_init(j_cfg, jax.random.PRNGKey(0))
        if cfg.qkv_bias:
            j_params = _with_biases(j_params, 1)
        tokens = np.random.default_rng(2).integers(
            0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p, t: j_tf.lm_loss(j_cfg, p, t), has_aux=True))(
                j_params, jnp.asarray(tokens))
        _CELLS[arch] = {"j_cfg": j_cfg, "cfg": cfg, "j_params": j_params,
                        "host": jax.tree.map(np.asarray, j_params),
                        "tokens": tokens, "loss": loss, "aux": aux,
                        "grads": grads}
    return _CELLS[arch]


# --------------------------------------------------------------- registry

def test_registry_and_cells_are_jaxs():
    assert base.ARCH_IDS == j_base.ARCH_IDS
    assert list(base.registry()) == list(j_base.registry())
    names = [(s.arch_id, sh.name) for s, sh in base.all_cells()]
    assert names == [(s.arch_id, sh.name) for s, sh in j_base.all_cells()]
    assert len(names) == 40
    assert base.get_arch("llama4-maverick-400b-a17b").arch_id == \
        "llama4_maverick_400b_a17b"


@pytest.mark.parametrize("arch", j_base.ARCH_IDS)
def test_configs_are_jaxs_field_for_field(arch):
    spec, j_spec = base.get_arch(arch), j_base.get_arch(arch)
    assert (spec.family, spec.source) == (j_spec.family, j_spec.source)
    for got, want in ((spec.config, j_spec.config),
                      (spec.reduced, j_spec.reduced)):
        assert type(got).__name__ == type(want).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        if spec.family == "lm":
            assert got.param_count() == want.param_count()
            assert got.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("shape", [s.name for s in base.LM_SHAPES])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_build_bundle_builds_every_lm_shape(arch, shape):
    b = steps.build_bundle(base.get_arch(arch), shape, reduced=True,
                           device="cpu")
    j_b = j_steps.build_bundle(j_base.get_arch(arch), shape, reduced=True)
    assert b.step_kind == j_b.step_kind
    assert (b.shape.seq_len, b.shape.global_batch) == (
        j_b.shape.seq_len, j_b.shape.global_batch)


# ------------------------------------------------------------ each arch

@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_jax(arch):
    """``lm_loss``'s loss, ``ce``, ``lb_loss`` (nonzero where a block is
    MoE) and every gradient leaf against ``jax.value_and_grad``."""
    c = _cell(arch)
    grads, (loss, aux) = steps.autograd_grads(
        lambda p, t: tf.lm_loss(c["cfg"], p, t))(
            tr.map_tree(_t, c["host"]), _t(c["tokens"]))
    _close(loss, c["loss"], **LOSS_TOL)
    _close(aux["ce"], c["aux"]["ce"], **LOSS_TOL)
    _close(aux["lb_loss"], c["aux"]["lb_loss"], **LOSS_TOL)
    assert (float(aux["lb_loss"]) > 0) == (c["cfg"].moe is not None)
    _leaves_close(grads, c["grads"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_bundle_matches_jax(arch):
    """``prefill_32k`` REDUCED through both bundles: the last-token logits
    and every cache leaf."""
    c = _cell(arch)
    j_b = j_steps.build_bundle(j_base.get_arch(arch), "prefill_32k",
                               reduced=True)
    b = steps.build_bundle(base.get_arch(arch), "prefill_32k", reduced=True,
                           device="cpu")
    batch, j_batch = b.make_batch(0), j_b.make_batch(0)
    np.testing.assert_array_equal(batch["tokens"].numpy(), j_batch["tokens"])
    want, j_cache = jax.jit(j_b.fn)(c["j_params"], j_batch)
    got, cache = b.fn(from_jax_params(c["host"], "cpu"), batch)
    _close(got, want, **TOL)
    for t, jc in enumerate(j_cache):
        for n in "kv":
            _close(cache[t][n], jc[n], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    """A 20-token prompt into a 24-deep cache, then a decode step at the
    scalar position 20 and one at per-sequence positions (21, 18): the
    logits and the cache against JAX's."""
    c = _cell(arch)
    params = from_jax_params(c["host"], "cpu")
    prompt = c["tokens"][:, :20]
    _, j_cache, _ = jax.jit(lambda p, t: j_tf.prefill(c["j_cfg"], p, t, 24))(
        c["j_params"], jnp.asarray(prompt))
    _, cache, _ = tf.prefill(c["cfg"], params, _t(prompt), 24)
    j_decode = jax.jit(lambda p, cc, pos, tok: j_tf.decode_step(
        c["j_cfg"], p, cc, pos, tok))
    for j_pos, pos, tok in ((jnp.int32(20), torch.tensor(20), [5, 6]),
                            (jnp.asarray([21, 18], jnp.int32),
                             torch.tensor([21, 18]), [7, 8])):
        tok = np.asarray(tok, np.int32)
        want, j_cache = j_decode(c["j_params"], j_cache, j_pos,
                                 jnp.asarray(tok))
        got, cache = tf.decode_step(c["cfg"], params, cache, pos, _t(tok))
        _close(got, want, **TOL)
    for t, jc in enumerate(j_cache):
        for n in "kv":
            _close(cache[t][n], jc[n], **TOL)


# --------------------------------------------------------------- options

@pytest.mark.parametrize("dropped", ["bq", "bk", "bv"])
def test_qkv_bias_is_applied_and_a_dropped_bias_fails(dropped):
    """qwen's REDUCED config with nonzero biases: the port's prefill and
    train step match JAX's (the test above and
    ``test_prefill_bundle_matches_jax``), and the same port with one bias
    zeroed differs from JAX's by far more than the tolerance, in the
    prefill logits and in the train loss."""
    c = _cell("qwen1_5_110b")
    bad = tr.map_tree(_t, c["host"])
    for block in bad["blocks"]:
        assert block["attn"][dropped].abs().min() > 0
        block["attn"][dropped].zero_()
    prompt = c["tokens"][:, :20]
    want, _, _ = jax.jit(lambda p, t: j_tf.prefill(c["j_cfg"], p, t, 20))(
        c["j_params"], jnp.asarray(prompt))
    got, _, _ = tf.prefill(c["cfg"], tf.Transformer.from_tree(bad),
                           _t(prompt), 20)
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err > 100 * TOL["atol"], err
    with torch.no_grad():
        loss, _ = tf.lm_loss(c["cfg"], bad, _t(c["tokens"]))
    assert abs(float(loss) - float(c["loss"])) > 100 * LOSS_TOL["rtol"] * \
        float(c["loss"])


def test_tie_embeddings_matches_jax_and_the_head_trains_embed():
    """yi's REDUCED config with ``tie_embeddings``: no ``unembed`` in
    either tree; the forward logits, the loss, every gradient leaf, the
    prefill and a decode step against JAX's.  The embedding rows of
    tokens absent from the batch get a gradient only through the head,
    and it is JAX's."""
    j_cfg = dataclasses.replace(j_base.get_arch("yi_34b").reduced,
                                tie_embeddings=True)
    cfg = dataclasses.replace(base.get_arch("yi_34b").reduced,
                              tie_embeddings=True)
    j_params = _j_init(j_cfg, jax.random.PRNGKey(4))
    host = jax.tree.map(np.asarray, j_params)
    assert "unembed" not in host
    assert "unembed" not in tf.init_tree(cfg, torch.Generator().manual_seed(0))
    params = from_jax_params(host, "cpu")
    assert params.unembed is None
    assert "unembed" not in dict(params.named_parameters())
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 17)).astype(
        np.int32)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p, t: j_tf.lm_loss(j_cfg, p, t, loss_chunk=16),
        has_aux=True))(j_params, jnp.asarray(tokens))
    grads, (loss, _) = steps.autograd_grads(
        lambda p, t: tf.lm_loss(cfg, p, t, loss_chunk=16))(
            tr.map_tree(_t, host), _t(tokens))
    _close(loss, j_loss, **LOSS_TOL)
    _leaves_close(grads, j_grads)
    paths = [tr.key_of(p) for p, _ in tr.leaves_with_paths(host)]
    g_embed = grads[paths.index("embed")]
    unseen = np.setdiff1d(np.arange(cfg.vocab), tokens[:, :-1])
    assert unseen.size and float(g_embed[unseen].abs().sum()) > 0
    want, _ = jax.jit(lambda p, t: j_tf.forward(j_cfg, p, t))(
        j_params, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = tf.forward(cfg, tr.map_tree(_t, host), _t(tokens))
    _close(got, want, **TOL)
    want, j_cache, _ = jax.jit(lambda p, t: j_tf.prefill(j_cfg, p, t, 20))(
        j_params, jnp.asarray(tokens[:, :16]))
    got, cache, _ = tf.prefill(cfg, params, _t(tokens[:, :16]), 20)
    _close(got, want, **TOL)
    want, _ = jax.jit(lambda p, cc, t: j_tf.decode_step(
        j_cfg, p, cc, jnp.int32(16), t))(j_params, j_cache,
                                          jnp.asarray(tokens[:, 16]))
    got, _ = tf.decode_step(cfg, params, cache, 16, _t(tokens[:, 16]))
    _close(got, want, **TOL)
    assert to_numpy(params).keys() == host.keys()


@pytest.mark.parametrize("arch", ["dbrx_132b", "llama4_maverick_400b_a17b"])
def test_moe_train_state_checkpoints_cross_both_ways(arch, tmp_path):
    """A MoE train state saved by the port restores bitwise in JAX under
    JAX's keys (``params/blocks/0/moe/w_gate``, llama4's
    ``.../moe/shared/w_down``), and JAX's restores bitwise in the port."""
    c = _cell(arch)
    j_b = j_steps.build_bundle(j_base.get_arch(arch), "train_4k",
                               reduced=True)
    j_state = j_b.make_state(c["j_params"])
    state = train_state_from_jax(jax.tree.map(np.asarray, j_state), "cpu")
    CheckpointManager(str(tmp_path / "port"), keep=1).save(3, state)
    host = train_state_to_numpy(state)
    restored, step = JCheckpointManager(str(tmp_path / "port")).restore(host)
    assert step == 3
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(a, b)
    with open(tmp_path / "port" / "step_3" / "manifest.json") as f:
        keys = [e["key"] for e in json.load(f)["leaves"]]
    moe_block = 0 if arch == "dbrx_132b" else 1
    assert f"params/blocks/{moe_block}/moe/w_gate" in keys
    assert f"opt/m/blocks/{moe_block}/moe/router" in keys
    if arch != "dbrx_132b":
        assert "params/blocks/1/moe/shared/w_down" in keys
    assert keys == ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                             for k in p) for p, _ in
                    jax.tree_util.tree_flatten_with_path(host)[0]]
    JCheckpointManager(str(tmp_path / "jax")).save(3, j_state)
    back, step = CheckpointManager(str(tmp_path / "jax")).restore(
        tr.map_tree(torch.zeros_like, state))
    assert step == 3
    for a, b in zip(tr.leaves(back), jax.tree.leaves(j_state)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_moe_weights_round_trip_bitwise_with_jaxs_names():
    """llama4's bf16 tree (a dense and an MoE block, the shared expert)
    through ``from_jax_params`` and ``to_numpy``: bitwise, each dotted
    parameter name its JAX path (``blocks.1.moe.shared.w_gate``)."""
    cfg = dataclasses.replace(j_base.get_arch(
        "llama4_maverick_400b_a17b").reduced, dtype="bfloat16")
    host = jax.tree.map(np.asarray, _j_init(cfg, jax.random.PRNGKey(6)))
    params = from_jax_params(host, "cpu")
    back = to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    paths = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(host)}
    assert {n for n, _ in params.named_parameters()} == paths
    assert "blocks.1.moe.shared.w_gate" in paths
    assert params.blocks[1].moe.router.dtype == torch.float32


@pytest.mark.parametrize("shape", [(3, 40, 50), (7000,), (1, 6, 30, 20)])
def test_scaled_normal_draws_in_bounded_slices(shape, monkeypatch):
    """A leaf of at most ``DRAW_ELEMS`` elements is one ``randn`` draw
    (bitwise the whole draw); a larger one is drawn in slices over its
    leading dims, none over ``DRAW_ELEMS`` elements, at the same scale."""
    gen = torch.Generator().manual_seed(0)
    whole = (torch.randn(shape, generator=gen) * 0.25).to(torch.bfloat16)
    got = core.scaled_normal(shape, 0.25, torch.bfloat16,
                             torch.Generator().manual_seed(0))
    assert got.dtype == torch.bfloat16 and torch.equal(got, whole)
    sizes, randn = [], torch.randn

    def recording(size, **kw):
        sizes.append(math.prod(size))
        return randn(size, **kw)

    monkeypatch.setattr(core, "DRAW_ELEMS", 500)
    monkeypatch.setattr(torch, "randn", recording)
    got = core.scaled_normal(shape, 0.25, torch.float32,
                             torch.Generator().manual_seed(0))
    assert got.shape == shape and sum(sizes) == math.prod(shape)
    assert len(sizes) > 1 and max(sizes) <= 500
    assert abs(float(got.std()) - 0.25) <= 4 * 0.25 / math.sqrt(
        2 * got.numel())


# ------------------------------------------------------------- launchers

@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_the_arch(arch, tmp_path, monkeypatch, capsys):
    """``launch.train`` (2 steps) and ``launch.serve`` (3 requests) on the
    REDUCED config; the serve launcher from JAX's seed-0 weights gives
    the JAX serve launcher's tokens, request by request."""
    argv = ["--arch", arch.replace("_", "-"), "--shape", "train_4k",
            "--steps", "2", "--ckpt-every", "2", "--reduced", "--device",
            "cpu", "--ckpt-dir", str(tmp_path)]
    assert train_launcher.main(argv) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1 and "'step': 2" in lines[0]

    c = _cell(arch)
    params = from_jax_params(c["host"], "cpu")
    monkeypatch.setattr(tf, "init_params", lambda cfg, gen: params)
    argv = ["--arch", arch, "--reduced", "--requests", "3", "--slots", "2",
            "--max-len", "16", "--max-new-tokens", "3"]
    seen = {}
    assert serve_launcher.main(argv + ["--device", "cpu"], on_done=lambda
                               s, d, t: seen.update(done=d)) == 0
    mine = capsys.readouterr().out.strip().splitlines()
    j_done = []

    class Recording(JServer):
        def __init__(self, cfg, p, **kw):
            super().__init__(cfg, c["j_params"], **kw)

        def run_until_drained(self, *a, **kw):
            j_done.extend(super().run_until_drained(*a, **kw))
            return j_done

    monkeypatch.setattr(j_serve_launcher, "Server", Recording)
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    j_serve_launcher.main()
    theirs = capsys.readouterr().out.strip().splitlines()
    assert mine[0].split(",")[:2] == theirs[0].split(",")[:2] == [
        "3 requests", " 9 tokens"]
    assert {r.rid: r.out for r in seen["done"]} == {
        r.rid: r.out for r in j_done}
