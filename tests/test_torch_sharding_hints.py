"""The port's sharding hints (``models.sharding_hints``) on the CPU
against the JAX package's: under hints each ``constrain_*`` returns its
input and records the spec JAX's ``_constrain`` receives (captured by
patching ``_constrain`` in this process; no JAX file changes), on JAX's
``AbstractMesh`` and the port's meta ``LocalMesh`` of the same shape, in
one abstract step of REDUCED cells (the port's on meta tensors, JAX's
under ``jax.eval_shape``).  Specs compare exactly.  The hints are cleared
around every test, and on an exception."""

import functools
import sys

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import base as j_base
from repro.launch import shardings as j_sh
from repro.launch import steps as j_steps
from repro.models import sharding_hints as j_hints
from repro_torch.configs import base
from repro_torch.core.mesh import LocalMesh
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import shardings as sh
from repro_torch.launch import steps
from repro_torch.launch.dryrun import meta_generator
from repro_torch.models import sharding_hints

torch.set_num_threads(1)

#: reduced cells whose steps call every constrain_* but the MoE's: (arch,
#: shape, mesh, sequence sharding)
CELLS = [("gemma3_12b", "train_4k", "2x4", True),
         ("gemma3_12b", "prefill_32k", "2x4", True),
         ("gemma3_12b", "decode_32k", "2x2x2", True),
         ("qwen1_5_110b", "train_4k", "2x4", True),
         ("qwen1_5_110b", "train_4k", "2x2x2", False),
         ("yi_34b", "train_4k", "2x2x2", True),
         ("yi_34b", "train_4k", "2x4", False),
         ("gcn_cora", "full_graph_sm", "2x4", True),
         ("gatedgcn", "minibatch_lg", "2x2x2", True),
         ("schnet", "molecule", "2x4", True),
         ("graphcast", "ogb_products", "2x4", True),
         ("deepfm", "train_batch", "2x2x2", True)]
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def _no_hints_left():
    """Hints are module state: every test starts and ends without."""
    sharding_hints.clear_hints()
    j_hints.clear_hints()
    yield
    sharding_hints.clear_hints()
    j_hints.clear_hints()


def _jax_records(bundle, amesh, seq_shard):
    """(name, shape, spec entries) of every ``_constrain`` call of one
    abstract step under JAX's hints."""
    rec = []

    def capture(x, spec):
        frame = sys._getframe(1)     # the constrain_* (grads: via a lambda)
        while not frame.f_code.co_name.startswith("constrain_"):
            frame = frame.f_back
        rec.append((frame.f_code.co_name, tuple(x.shape), tuple(spec)))
        return x

    ax = j_sh.mesh_axes(amesh)
    params = jax.eval_shape(bundle.init_params, jax.random.PRNGKey(0))
    pspecs = (j_sh.lm_param_specs(bundle.cfg, amesh)
              if bundle.family == "lm" else
              j_sh.gnn_param_specs(params, amesh) if bundle.family == "gnn"
              else j_sh.recsys_param_specs(bundle.cfg, amesh))
    if bundle.step_kind == "train":
        args = (jax.eval_shape(bundle.make_state, params),
                bundle.input_specs())
    else:
        args = (params, bundle.input_specs())
    orig = j_hints._constrain
    j_hints._constrain = capture
    try:
        with j_hints.hints(amesh, ax.dp, ax.model, ax.flat,
                           seq_shard=seq_shard,
                           param_specs=pspecs if bundle.step_kind == "train"
                           else None):
            jax.eval_shape(bundle.fn, *args)
    finally:
        j_hints._constrain = orig
    return rec


def _meta_fn(bundle):
    """The step on meta tensors: the prefill with its plain attention, as
    the dry run calls it (A4's wrapper takes CPU or CUDA tensors)."""
    if bundle.step_kind == "prefill":
        return functools.partial(bundle.fn, use_kernel=False)
    return bundle.fn


def _port_records(bundle, pm, seq_shard):
    ax = pmesh.mesh_axes(pm)
    params = bundle.init_params(meta_generator())
    tree = params.tree() if hasattr(params, "tree") else params
    pspecs = (sh.lm_param_specs(bundle.cfg, pm) if bundle.family == "lm"
              else sh.gnn_param_specs(tree, pm) if bundle.family == "gnn"
              else sh.recsys_param_specs(bundle.cfg, pm))
    state = (bundle.make_state(params) if bundle.step_kind == "train"
             else params)
    with sharding_hints.hints(pm, ax.dp, ax.model, ax.flat,
                              seq_shard=seq_shard,
                              param_specs=pspecs
                              if bundle.step_kind == "train" else None), \
            sharding_hints.recording() as rec:
        _meta_fn(bundle)(state, bundle.input_specs())
    return [(n, s, tuple(spec)) for n, s, spec in rec]


@pytest.mark.parametrize("arch,shape,mesh_name,seq_shard", CELLS)
def test_constraints_record_jaxs_specs(arch, shape, mesh_name, seq_shard):
    """Every (call site, shape, spec) JAX's ``_constrain`` receives in one
    abstract step is one the port records, and the other way round (JAX
    traces a scanned body once, the port runs every layer and loss chunk,
    so the sets compare); nothing records with hints unset."""
    shp, names = MESHES[mesh_name]
    j_bundle = j_steps.build_bundle(j_base.get_arch(arch), shape,
                                    reduced=True)
    p_bundle = steps.build_bundle(base.get_arch(arch), shape, reduced=True,
                                  device="meta")
    want = set(_jax_records(j_bundle, AbstractMesh(shp, names), seq_shard))
    got = set(_port_records(p_bundle, LocalMesh(shp, names, "meta"),
                            seq_shard))
    assert want and got == want
    with sharding_hints.recording() as rec:
        params = p_bundle.init_params(meta_generator())
        state = (p_bundle.make_state(params)
                 if p_bundle.step_kind == "train" else params)
        _meta_fn(p_bundle)(state, p_bundle.input_specs())
    assert rec == []


def test_constraints_return_their_input():
    x = torch.zeros(4, 8, 6)
    with sharding_hints.hints(LocalMesh((2, 2), ("data", "model"), "cpu"),
                              ("data",), "model", ("data", "model")), \
            sharding_hints.recording() as rec:
        assert sharding_hints.enabled()
        for f in (sharding_hints.constrain_tokens_3d,
                  sharding_hints.constrain_logits_3d,
                  sharding_hints.constrain_expert_buffer,
                  sharding_hints.constrain_tokens_full,
                  sharding_hints.constrain_rows):
            assert f(x) is x
        x4 = torch.zeros(4, 2, 8, 6)
        assert sharding_hints.constrain_heads_4d(x4) is x4
    assert not sharding_hints.enabled()
    assert [(n, tuple(s)) for n, _, s in rec] == [
        ("constrain_tokens_3d", ("data", "model", None)),
        ("constrain_logits_3d", ("data", None, "model")),
        ("constrain_expert_buffer", ("model", None, None)),
        ("constrain_tokens_full", ("data", None, None)),
        ("constrain_rows", (("data", "model"), None, None)),
        ("constrain_heads_4d", ("data", "model", None, None))]


def test_hints_clear_on_an_exception():
    with pytest.raises(RuntimeError):
        with sharding_hints.hints(LocalMesh((1, 2), ("data", "model"), "cpu"),
                                  ("data",), "model"):
            raise RuntimeError("step failed")
    assert not sharding_hints.enabled()
