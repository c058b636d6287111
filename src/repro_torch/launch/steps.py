"""Step builder: (architecture x shape) -> step function and inputs — the
port of ``repro.launch.steps``.

``build_bundle(spec, shape, reduced=..., device=..., opt_cfg=...,
microbatches=...)`` gives ``init_params(generator)``, ``make_state(params)``
(train: ``{"params", "opt"}``), ``make_batch(seed)`` (the JAX bundle's
inputs, as tensors on the device) and ``fn(state, batch)``:

  lm      train      -> (new state, {"loss", "grad_norm", "lr"})
          prefill    -> (last-token logits, cache)
          decode     -> (logits, cache): one token against a ``seq_len``-deep
                        cache (``make_batch``: a zero cache, ``pos =
                        seq_len - 1``)
  gnn     train      -> (new state, {"loss", "grad_norm", "lr"}), every
                        shape mode (``make_batch``: ``gnn_batch`` padded
                        to 128, 64 when reduced, as JAX's bundle pads)
  recsys  train      -> (new state, {"loss", "grad_norm", "lr"})
          serve      -> (B,) sigmoid scores
          retrieval  -> (n_candidates,) scores

``microbatches`` reaches only the LM train step, as in the JAX package
(whose GNN and recsys train steps are built without it).  The JAX
bundle's ``input_specs`` (abstract inputs for the XLA dry-run) has no
counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.configs.base import (ArchSpec, GNNShape, LMShape,
                                      RecsysShape, get_shape)
from repro_torch.data import synthetic as syn
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import models as gnn
from repro_torch.models.recsys import deepfm
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     apply_updates_, init_state)


@dataclasses.dataclass
class StepBundle:
    arch_id: str
    family: str
    step_kind: str           # train | prefill | decode | serve | retrieval
    cfg: Any
    shape: Any
    device: torch.device
    init_params: Callable    # torch.Generator -> params
    make_state: Callable     # params -> state (train) or params (serve)
    fn: Callable             # (state, batch) -> outputs; the LM prefill
                             # also takes use_kernel=True
    make_batch: Callable     # (seed) -> batch of tensors on the device


def reduce_shape(shape, family: str):
    """Tiny same-structure shape for CPU smoke tests."""
    if family == "lm":
        return LMShape(shape.name, shape.step, seq_len=32, global_batch=2)
    if family == "gnn":
        kw = dict(name=shape.name, mode=shape.mode)
        if shape.mode == "sampled":
            return GNNShape(**kw, n_nodes=64, n_edges=256, d_feat=12,
                            batch_nodes=8, fanout=(3, 2))
        if shape.mode == "batched":
            return GNNShape(**kw, n_nodes=10, n_edges=24, d_feat=12,
                            batch_graphs=4)
        return GNNShape(**kw, n_nodes=200, n_edges=800, d_feat=12)
    if family == "recsys":
        return RecsysShape(shape.name, shape.step, batch=64,
                           n_candidates=256 if shape.step == "retrieval" else 0)
    raise ValueError(family)


def autograd_grads(loss_fn):
    """``torch.func.grad_and_value(loss_fn, has_aux=True)`` by
    ``torch.autograd``, over detached leaves that require grad; returns
    (gradients in leaf order as a list, (loss, aux)), all detached.  A
    leaf the loss does not reach gets zeros, as from ``jax.grad`` (the
    last GatedGCN layer's edge norm)."""
    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_() for p in tr.leaves(params)]
        loss, aux = loss_fn(tr.unflatten(params, leaves), batch)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        return grads, (loss.detach(), tr.map_tree(torch.Tensor.detach, aux))
    return grad_fn


def _train_wrap(loss_fn, opt_cfg: AdamWConfig, microbatches: int = 1, *,
                autograd: bool = False, in_place: bool = False):
    """fwd + bwd + AdamW step ``(state, batch) -> (new_state, metrics)``;
    with microbatches > 1 the batch is split on its leading axis and the
    gradients accumulate in f32 as ``acc + g / microbatches`` (the loss as
    ``l / microbatches``), in the JAX scan's order.

    Two choices, each off by default (DeepFM's step):

    * ``autograd``: gradients from ``torch.autograd`` (``autograd_grads``)
      instead of ``torch.func``, for a loss that runs under
      ``torch.utils.checkpoint``, whose saved-tensor hooks ``torch.func``
      cannot differentiate through (the LM step's remat and loss chunks,
      the GNN layers);
    * ``in_place``: the update writes the state's own buffers
      (``apply_updates_``), for a state too large to hold twice (the LM
      step).  Otherwise the update is functional and the old state stays
      as it was.

    JAX's ``hints.constrain_grads`` (``repro/models/sharding_hints.py``)
    is the identity unless a mesh is active; on one card it has nothing to
    constrain, so it has no counterpart here."""
    if autograd:
        grad_fn = autograd_grads(loss_fn)
    else:
        func_grad = torch.func.grad_and_value(loss_fn, has_aux=True)

        def grad_fn(params, batch):
            grads, loss_aux = func_grad(params, batch)
            return tr.leaves(grads), loss_aux

    def step(state, batch):
        params = state["params"]
        if microbatches == 1:
            grads, (loss, _) = grad_fn(params, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in tr.leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
            for i in range(microbatches):
                micro = tr.map_tree(lambda x: x.reshape(
                    microbatches, x.shape[0] // microbatches,
                    *x.shape[1:])[i], batch)
                g, (l, _) = grad_fn(params, micro)
                for j, a in enumerate(grads):
                    a.add_(g[j].to(torch.float32) / microbatches)
                    g[j] = None
                loss = loss + l / microbatches
        if in_place:
            new_p, new_opt, m = apply_updates_(opt_cfg, params, grads,
                                               state["opt"])
        else:
            new_p, new_opt, m = apply_updates(
                opt_cfg, params, tr.unflatten(params, grads), state["opt"])
        return {"params": new_p, "opt": new_opt}, {"loss": loss, **m}
    return step


def _make_state(params):
    return {"params": params, "opt": init_state(params)}


def _lm_bundle(spec: ArchSpec, shape: LMShape, cfg, device: torch.device,
               opt_cfg: AdamWConfig, microbatches: int) -> StepBundle:
    if shape.step == "train":
        return _lm_train_bundle(spec, shape, cfg, device, opt_cfg,
                                microbatches)
    if shape.step == "decode":
        return _lm_decode_bundle(spec, shape, cfg, device)

    def fn(params, batch, use_kernel: bool = True):
        logits, cache, _ = tf.prefill(cfg, params, batch["tokens"],
                                      max_len=shape.seq_len,
                                      use_kernel=use_kernel)
        return logits, cache

    def make_batch(seed=0):
        tokens = syn.lm_train_batch(cfg, shape.global_batch,
                                    shape.seq_len - 1, seed)["tokens"]
        return {"tokens": torch.from_numpy(tokens).to(device)}

    return StepBundle(
        spec.arch_id, "lm", "prefill", cfg, shape, device,
        init_params=lambda generator: tf.init_params(cfg, generator),
        make_state=lambda p: p, fn=fn, make_batch=make_batch)


def _lm_train_bundle(spec: ArchSpec, shape: LMShape, cfg,
                     device: torch.device, opt_cfg: AdamWConfig,
                     microbatches: int) -> StepBundle:
    """fwd + bwd + AdamW over ``global_batch`` sequences of ``seq_len``
    tokens (``make_batch``: (B, seq_len + 1) tokens), on the JAX-layout
    dict of ``tf.init_tree``, updated in place.  It runs the config's
    remat (``block`` in every ported config, as in JAX) and takes its
    gradients by ``torch.autograd``, because ``torch.func`` cannot
    differentiate through the checkpoint that remat and the loss chunks
    run under."""
    fn = _train_wrap(lambda p, b: tf.lm_loss(cfg, p, b["tokens"]), opt_cfg,
                     microbatches, autograd=True, in_place=True)

    def make_batch(seed=0):
        tokens = syn.lm_train_batch(cfg, shape.global_batch, shape.seq_len,
                                    seed)["tokens"]
        return {"tokens": torch.from_numpy(tokens).to(device)}

    return StepBundle(
        spec.arch_id, "lm", "train", cfg, shape, device,
        init_params=lambda generator: tf.init_tree(cfg, generator),
        make_state=_make_state, fn=fn, make_batch=make_batch)


def _lm_decode_bundle(spec: ArchSpec, shape: LMShape, cfg,
                      device: torch.device) -> StepBundle:
    """One new token against a ``seq_len``-deep KV cache."""
    def fn(params, batch):
        return tf.decode_step(cfg, params, batch["cache"], batch["pos"],
                              batch["last_token"])

    def make_batch(seed=0):
        rng = np.random.default_rng(seed)
        tok = rng.integers(0, cfg.vocab, (shape.global_batch,))
        return {"cache": tf.init_cache(cfg, shape.global_batch,
                                       shape.seq_len, device=device),
                "pos": torch.tensor(shape.seq_len - 1, dtype=torch.int32,
                                    device=device),
                "last_token": torch.from_numpy(tok.astype("int32")).to(
                    device)}

    return StepBundle(
        spec.arch_id, "lm", "decode", cfg, shape, device,
        init_params=lambda generator: tf.init_params(cfg, generator),
        make_state=lambda p: p, fn=fn, make_batch=make_batch)


def _to_device(arrays: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}


def _gnn_bundle(spec: ArchSpec, shape: GNNShape, cfg, device: torch.device,
                opt_cfg: AdamWConfig, pad: int) -> StepBundle:
    """fwd + bwd + AdamW over one ``gnn_batch`` (a graph padded to
    ``pad``, as the JAX bundle draws it).  The layers run under
    ``torch.utils.checkpoint``, so the gradients come from
    ``torch.autograd``; the update is functional (the state is small)."""
    fn = _train_wrap(lambda p, b: gnn.loss_fn(cfg, p, b), opt_cfg,
                     autograd=True)

    def make_batch(seed=0):
        return _to_device(syn.gnn_batch(cfg, shape, seed=seed, pad=pad),
                          device)

    return StepBundle(
        spec.arch_id, "gnn", "train", cfg, shape, device,
        init_params=lambda generator: gnn.init_params(cfg, shape.d_feat,
                                                      generator),
        make_state=_make_state, fn=fn, make_batch=make_batch)


def _recsys_bundle(spec: ArchSpec, shape: RecsysShape, cfg,
                   device: torch.device, opt_cfg: AdamWConfig) -> StepBundle:
    if shape.step == "train":
        fn = _train_wrap(lambda p, b: deepfm.loss_fn(cfg, p, b), opt_cfg)
        make_state = _make_state
    else:
        step = (deepfm.serve_step if shape.step == "serve"
                else deepfm.retrieval_step)

        def fn(params, batch):
            return step(cfg, params, batch)

        def make_state(params):
            return params

    def make_batch(seed=0):
        return _to_device(syn.recsys_batch(
            cfg, shape.batch, step=shape.step,
            n_candidates=shape.n_candidates, seed=seed), device)

    return StepBundle(
        spec.arch_id, "recsys", shape.step, cfg, shape, device,
        init_params=lambda generator: deepfm.init_params(cfg, generator),
        make_state=make_state, fn=fn, make_batch=make_batch)


def build_bundle(spec: ArchSpec, shape_or_name, *, reduced: bool = False,
                 device="cuda", opt_cfg: AdamWConfig = AdamWConfig(),
                 microbatches: int = 1) -> StepBundle:
    """The step of one (architecture, shape) cell on ``device`` (the card
    unless the caller passes ``device="cpu"``)."""
    if spec.family not in ("lm", "gnn", "recsys"):
        raise ValueError(f"build_bundle: unknown family {spec.family!r}")
    shape = (get_shape(spec, shape_or_name)
             if isinstance(shape_or_name, str) else shape_or_name)
    cfg = spec.reduced if reduced else spec.config
    if reduced:
        shape = reduce_shape(shape, spec.family)
        microbatches = min(microbatches, 2)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_bundle: no CUDA card; pass device='cpu' "
                           "to run the plain path on the CPU")
    if spec.family == "lm":
        return _lm_bundle(spec, shape, cfg, device, opt_cfg, microbatches)
    if spec.family == "gnn":
        # JAX's make_batch pads to min(pad, 128) with pad 512, or 64
        # reduced
        return _gnn_bundle(spec, shape, cfg, device, opt_cfg,
                           64 if reduced else 128)
    return _recsys_bundle(spec, shape, cfg, device, opt_cfg)
