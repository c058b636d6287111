"""The port's DeepFM serve and retrieval slice on the CPU against the JAX
package: configs, batches, the MLP, the weight carry-over and the two
steps through ``build_bundle``, at ``REDUCED`` and at full width with
``vocab_per_field`` cut to 1,000.  The first-order weights are drawn
non-zero: at init they are zero, and the 0.01-scale table makes the FM
term about 1e-3 beside the deep term."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch
from repro.data import synthetic as j_syn
from repro.launch.steps import build_bundle as j_build_bundle
from repro.models.gnn import common as j_common
from repro.models.recsys import deepfm as j_deepfm
from repro_torch.configs import RECSYS_SHAPES, get_arch, get_shape
from repro_torch.data import synthetic as syn
from repro_torch.launch.steps import build_bundle, reduce_shape
from repro_torch.models.convert import (deepfm_from_jax_params,
                                        deepfm_to_numpy)
from repro_torch.models.gnn.common import apply_mlp, init_mlp
from repro_torch.models.recsys import deepfm

torch.set_num_threads(1)

# f32 on both sides, sums and products in another order: the steps read
# at most 4.2e-7 apart on logits up to 2.9
TOL = {"atol": 1e-5, "rtol": 1e-5}
# (reduced, vocab_per_field of the full config); None keeps REDUCED's 100
CONFIGS = {"reduced": (True, None), "full-vocab1000": (False, 1000)}


def _specs(which):
    reduced, vocab = CONFIGS[which]
    j_spec, spec = j_get_arch("deepfm"), get_arch("deepfm")
    if vocab:
        j_spec = dataclasses.replace(j_spec, config=dataclasses.replace(
            j_spec.config, vocab_per_field=vocab))
        spec = dataclasses.replace(spec, config=dataclasses.replace(
            spec.config, vocab_per_field=vocab))
    return j_spec, spec, reduced


def _jax_params(j_bundle, seed=0):
    """The JAX package's weights with the first-order weights and the bias
    drawn non-zero from numpy."""
    params = dict(j_bundle.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    for name in ("lin_table", "lin_dense"):
        params[name] = jnp.asarray(rng.standard_normal(
            params[name].shape).astype(np.float32) * 0.1)
    params["bias"] = jnp.asarray(np.float32(0.3))
    return params


def test_configs_match_the_jax_package():
    spec, j_spec = get_arch("deepfm"), j_get_arch("deepfm")
    assert spec.family == j_spec.family == "recsys"
    assert spec.source == j_spec.source
    for mine, theirs in ((spec.config, j_spec.config),
                         (spec.reduced, j_spec.reduced)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.total_rows == theirs.total_rows
    assert spec.config.total_rows == 39_000_000
    assert ([dataclasses.asdict(s) for s in spec.shapes]
            == [dataclasses.asdict(s) for s in j_spec.shapes])
    assert get_shape(spec, "serve_bulk").batch == 262_144
    assert get_arch("gemma3_12b").shapes[0].name == "train_4k"
    assert reduce_shape(RECSYS_SHAPES[3], "recsys").n_candidates == 256


@pytest.mark.parametrize("step", ["train", "serve", "retrieval"])
@pytest.mark.parametrize("which", ["reduced", "full"])
def test_recsys_batch_is_bitwise(step, which):
    spec = get_arch("deepfm")
    cfg = spec.reduced if which == "reduced" else spec.config
    j_cfg = getattr(j_get_arch("deepfm"), "reduced" if which == "reduced"
                    else "config")
    mine = syn.recsys_batch(cfg, 32, step=step, n_candidates=100, seed=3)
    theirs = j_syn.recsys_batch(j_cfg, 32, step=step, n_candidates=100,
                                seed=3)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(mine[k], theirs[k])


def test_mlp_matches_jax():
    layers = j_common.init_mlp(jax.random.PRNGKey(0), (13, 32, 32, 1))
    x = np.random.default_rng(0).standard_normal((20, 13)).astype(np.float32)
    want = np.asarray(j_common.apply_mlp(layers, jnp.asarray(x)))
    mine = [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
            for layer in layers]
    np.testing.assert_allclose(apply_mlp(mine, torch.from_numpy(x)).numpy(),
                               want, **TOL)
    drawn = init_mlp(torch.Generator().manual_seed(0), (403, 400, 1))
    assert [tuple(layer["w"].shape) for layer in drawn] == [(403, 400),
                                                          (400, 1)]
    assert not drawn[0]["b"].any()
    assert abs(float(drawn[0]["w"].std()) - 403 ** -0.5) < 1e-3
    assert all(layer["w"].dtype == layer["b"].dtype == torch.float32
               for layer in drawn)


@pytest.mark.parametrize("field,value", [("interaction", "dcn"),
                                         ("dtype", "bfloat16")])
def test_a_config_the_port_does_not_implement_raises(field, value):
    """Only the FM interaction in f32 is ported; another value raises
    rather than being ignored."""
    cfg = dataclasses.replace(get_arch("deepfm").reduced, **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        deepfm.init_params(cfg, torch.Generator())
    with pytest.raises(NotImplementedError, match=field):
        deepfm.forward(cfg, {}, {})


def test_init_params_draws_as_the_jax_package():
    cfg = dataclasses.replace(get_arch("deepfm").config, vocab_per_field=1000)
    p = deepfm.init_params(cfg, torch.Generator().manual_seed(0))
    j = j_deepfm.init_params(cfg, jax.random.PRNGKey(0))
    for name in ("table", "lin_table", "lin_dense", "bias"):
        assert p[name].shape == j[name].shape and p[name].dtype == torch.float32
    assert [tuple(layer["w"].shape) for layer in p["mlp"]] == [
        tuple(layer["w"].shape) for layer in j["mlp"]] == [
        (403, 400), (400, 400), (400, 400), (400, 1)]
    assert abs(float(p["table"].std()) - 0.01) < 1e-4
    assert not (p["lin_table"].any() or p["lin_dense"].any() or p["bias"])


def test_convert_round_trip_is_bitwise():
    j_bundle = j_build_bundle(j_get_arch("deepfm"), "serve_p99",
                              reduced=True)
    tree = jax.tree.map(np.asarray, _jax_params(j_bundle))
    params = deepfm_from_jax_params(tree, "cpu")
    assert isinstance(params["mlp"][0]["w"], torch.Tensor)
    back = deepfm_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="DeepFM"):
        deepfm_from_jax_params({"table": tree["table"]}, "cpu")


@pytest.mark.parametrize("which,shape", [
    ("reduced", "serve_p99"), ("reduced", "serve_bulk"),
    ("reduced", "retrieval_cand"), ("full-vocab1000", "serve_p99"),
    ("full-vocab1000", "retrieval_cand")])
def test_steps_match_jax(which, shape):
    """The bundle's step against the JAX bundle's on the same batch and
    weights: the gathered rows bitwise, the scores within TOL.  serve_bulk
    (262,144 rows of the full MLP) runs here only at REDUCED's batch of 64;
    chip_smoke.py runs it at full size."""
    j_spec, spec, reduced = _specs(which)
    j_bundle = j_build_bundle(j_spec, shape, reduced=reduced)
    bundle = build_bundle(spec, shape, reduced=reduced, device="cpu")
    assert bundle.step_kind == j_bundle.step_kind
    j_params = _jax_params(j_bundle)
    params = deepfm_from_jax_params(jax.tree.map(np.asarray, j_params),
                                    "cpu")
    j_batch = j_bundle.make_batch(0)
    batch = bundle.make_batch(0)
    for k in j_batch:
        np.testing.assert_array_equal(batch[k].numpy(), j_batch[k])
    jb = {k: jnp.asarray(v) for k, v in j_batch.items()}
    emb, flat = deepfm._embed(bundle.cfg, params, batch["sparse"])
    j_emb, j_flat = j_deepfm._embed(j_bundle.cfg, j_params, jb["sparse"])
    np.testing.assert_array_equal(flat.numpy(), np.asarray(j_flat))
    np.testing.assert_array_equal(emb.numpy(), np.asarray(j_emb))

    got = bundle.fn(params, batch).numpy()
    want = np.asarray(j_bundle.fn(j_params, jb))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    if bundle.step_kind == "serve":
        assert np.all((got >= 0) & (got <= 1))
        logits = deepfm.forward(bundle.cfg, params, batch).numpy()
        j_logits = np.asarray(j_deepfm.forward(j_bundle.cfg, j_params, jb))
        np.testing.assert_allclose(logits, j_logits, **TOL)
        # the FM term on its own: about 1e-3, hidden in the logits' TOL
        s = j_emb.sum(axis=1)
        j_fm = 0.5 * (jnp.square(s).sum(-1)
                      - jnp.square(j_emb).sum(axis=(1, 2)))
        np.testing.assert_allclose(deepfm.fm_term(emb).numpy(),
                                   np.asarray(j_fm), rtol=1e-5, atol=1e-8)


def test_bundle_defaults_to_the_card_and_refuses_the_train_step():
    """The bundle defaults to the card.  The train step, refused before
    its slice was ported (the name is kept), now builds and steps on the
    CPU: a finite loss, the step counted, every leaf of the state moved
    (tests/test_torch_train.py holds it to the JAX package)."""
    spec = get_arch("deepfm")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_bundle(spec, "serve_p99", reduced=True)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_bundle(spec, "train_batch", reduced=True)
    bundle = build_bundle(spec, "train_batch", reduced=True, device="cpu")
    assert bundle.step_kind == "train"
    state = bundle.make_state(bundle.init_params(
        torch.Generator().manual_seed(0)))
    new, metrics = bundle.fn(state, bundle.make_batch(0))
    assert np.isfinite(float(metrics["loss"]))
    assert int(new["opt"]["step"]) == 1
    assert all(not torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(new["params"]), jax.tree.leaves(state["params"])))


def test_field_offsets_shift_each_field_by_its_vocab():
    cfg = get_arch("deepfm").config
    off = deepfm.field_offsets(cfg)
    assert off.dtype == torch.int32
    np.testing.assert_array_equal(off.numpy(),
                                  np.asarray(j_deepfm.field_offsets(cfg)))
    assert int(off[-1]) == 38_000_000
