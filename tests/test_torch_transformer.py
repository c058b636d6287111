"""The port's LM prefill slice on the CPU against the JAX package: the
layers, the weight carry-over, the whole prefill of gemma3's REDUCED
config, and the step bundle.  The attention inside runs A4's plain
version here (CPU tensors); tests/test_torch_cuda.py runs the kernel."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch
from repro.layers import core as j_core
from repro.launch.steps import build_bundle as j_build_bundle
from repro.models import transformer as j_tf
from repro_torch.configs import get_arch, get_shape
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.launch.steps import build_bundle, reduce_shape
from repro_torch.layers import core
from repro_torch.models import transformer as tf
from repro_torch.models.convert import from_jax_params, to_numpy

torch.set_num_threads(1)

TOL = {"atol": 1e-5, "rtol": 1e-5}     # f32 on both sides, another order
_j_init = jax.jit(j_tf.init_params, static_argnums=0)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32) * 0.1
    want = np.asarray(j_core.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(core.rms_norm(_t(x), _t(w)).numpy(), want,
                               **TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    want = np.asarray(j_core.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = core.rope(_t(x), _t(pos), theta).numpy()
    # angles up to 39 rad: f32 sin/cos of two libraries differ by ulps
    np.testing.assert_allclose(got, want, **TOL)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(2)
    x, wg, wu, wd = (rng.standard_normal(s).astype(np.float32) * 0.3
                     for s in ((2, 7, 32), (32, 48), (32, 48), (48, 32)))
    want = np.asarray(j_core.swiglu(*map(jnp.asarray, (x, wg, wu, wd))))
    got = core.swiglu(*map(_t, (x, wg, wu, wd))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_params_round_trip_is_bitwise(dtype):
    cfg = dataclasses.replace(j_get_arch("gemma3_12b").reduced, dtype=dtype)
    tree = jax.tree.map(np.asarray, _j_init(cfg, jax.random.PRNGKey(3)))
    params = from_jax_params(tree, "cpu")
    assert params.blocks[5].attn.wq.dtype == getattr(torch, dtype)
    back = to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # a parameter's dotted name is its path in the JAX tree
    paths = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(tree)}
    assert {n for n, _ in params.named_parameters()} == paths


def test_prefill_matches_jax_on_gemma3_reduced():
    """Same weights (carried across) and the same tokens: last-token
    logits and every cache leaf within 1e-5 (f32)."""
    jb = j_build_bundle(j_get_arch("gemma3_12b"), "prefill_32k",
                        reduced=True)
    jparams = jb.init_params(jax.random.PRNGKey(0))
    batch = jb.make_batch(0)
    j_logits, j_cache = jax.jit(jb.fn)(jparams, batch)

    tb = build_bundle(get_arch("gemma3_12b"), "prefill_32k", reduced=True,
                      device="cpu")
    assert (tb.shape.global_batch, tb.shape.seq_len) == (2, 32)
    tbatch = tb.make_batch(0)
    np.testing.assert_array_equal(tbatch["tokens"].numpy(), batch["tokens"])
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    before = flash_attention.launches
    logits, cache = tb.fn(params, tbatch)
    assert flash_attention.launches == before        # CPU: plain attention
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **TOL)
    assert len(cache) == len(j_cache) == 6
    for t in range(6):
        for name in ("k", "v"):
            want = np.asarray(j_cache[t][name])
            assert cache[t][name].shape == want.shape
            np.testing.assert_allclose(cache[t][name].numpy(), want, **TOL)


def test_prefill_use_kernel_false_is_the_same_on_the_cpu():
    cfg = get_arch("gemma3_12b").reduced
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 20),
                           generator=torch.Generator().manual_seed(1))
    a, ca, s = tf.prefill(cfg, params, tokens, 24)
    b, cb, _ = tf.prefill(cfg, params, tokens, 24, use_kernel=False)
    assert s == 20 and torch.equal(a, b)
    assert all(torch.equal(x[n], y[n]) for x, y in zip(ca, cb) for n in "kv")
    assert not ca[0]["k"][:, :, :, 20:].any()        # past the prompt: zero
    with pytest.raises(ValueError, match="does not fit"):
        tf.prefill(cfg, params, tokens, 16)


def test_build_bundle_prefill_runs_end_to_end_on_the_cpu():
    b = build_bundle(get_arch("gemma3-12b"), "prefill_32k", reduced=True,
                     device="cpu")
    params = b.make_state(b.init_params(torch.Generator().manual_seed(0)))
    batch = b.make_batch(0)
    logits, cache = b.fn(params, batch)
    assert logits.shape == (2, b.cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert cache[0]["k"].shape == (1, 2, 2, 32, 16)
    assert all(bool(torch.isfinite(c[n]).all()) for c in cache for n in "kv")


def test_unported_archs_and_steps_raise():
    """An unknown arch and an unknown family raise (the LM decode and
    train steps, the GNN family and the MoE configs, refused before their
    slices, build: tests/test_torch_decode.py, test_torch_lm_train.py,
    test_torch_gnn.py, test_torch_lm_archs.py)."""
    with pytest.raises(KeyError, match="gemma3_12b"):
        get_arch("mixtral_8x7b")
    with pytest.raises(ValueError, match="moe"):
        reduce_shape(get_shape(get_arch("gemma3_12b"), "train_4k"), "moe")
    gnn_shape = get_shape(get_arch("gcn_cora"), "full_graph_sm")
    assert reduce_shape(gnn_shape, "gnn").n_nodes == 200
    with pytest.raises(ValueError, match="moe"):
        build_bundle(dataclasses.replace(get_arch("gemma3_12b"),
                                         family="moe"), "train_4k",
                     reduced=True, device="cpu")
    assert build_bundle(get_arch("gemma3_12b"), "train_4k", reduced=True,
                        device="cpu").step_kind == "train"
    assert build_bundle(get_arch("gemma3_12b"), "decode_32k", reduced=True,
                        device="cpu").step_kind == "decode"
