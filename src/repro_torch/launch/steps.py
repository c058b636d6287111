"""Step builder: (architecture x shape) -> step function and inputs — the
port of ``repro.launch.steps`` for the LM prefill step and the RecSys
serve and retrieval steps.

``build_bundle(spec, shape, reduced=..., device=...)`` gives
``init_params(generator)``, ``make_batch(seed)`` (the JAX bundle's inputs,
as tensors on the device) and ``fn(params, batch)``:

  lm      prefill    -> (last-token logits, cache)
  recsys  serve      -> (B,) sigmoid scores
          retrieval  -> (n_candidates,) scores

Other families and steps are later slices and raise
``NotImplementedError``.  The JAX bundle's ``input_specs`` (abstract
inputs for the XLA dry-run) has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchSpec, LMShape, RecsysShape, get_shape
from repro_torch.data import synthetic as syn
from repro_torch.models import transformer as tf
from repro_torch.models.recsys import deepfm


@dataclasses.dataclass
class StepBundle:
    arch_id: str
    family: str
    step_kind: str           # prefill | serve | retrieval
    cfg: Any
    shape: Any
    init_params: Callable    # torch.Generator -> params
    make_state: Callable     # params -> state (the params, for serving)
    fn: Callable             # (state, batch) -> outputs; the LM prefill
                             # also takes use_kernel=True
    make_batch: Callable     # (seed) -> batch of tensors on the device


def reduce_shape(shape, family: str):
    """Tiny same-structure shape for CPU smoke tests."""
    if family == "lm":
        return LMShape(shape.name, shape.step, seq_len=32, global_batch=2)
    if family == "recsys":
        return RecsysShape(shape.name, shape.step, batch=64,
                           n_candidates=256 if shape.step == "retrieval" else 0)
    raise NotImplementedError(f"family {family!r}: later slice")


def _lm_bundle(spec: ArchSpec, shape: LMShape, cfg,
               device: torch.device) -> StepBundle:
    if shape.step != "prefill":
        raise NotImplementedError(f"LM step {shape.step!r}: later slice")

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
        spec.arch_id, "lm", "prefill", cfg, shape,
        init_params=lambda generator: tf.init_params(cfg, generator),
        make_state=lambda p: p, fn=fn, make_batch=make_batch)


def _recsys_bundle(spec: ArchSpec, shape: RecsysShape, cfg,
                   device: torch.device) -> StepBundle:
    if shape.step == "train":
        raise NotImplementedError("recsys train step: a later slice "
                                  "(ROADMAP Queue A 13)")
    step = (deepfm.serve_step if shape.step == "serve"
            else deepfm.retrieval_step)

    def fn(params, batch):
        return step(cfg, params, batch)

    def make_batch(seed=0):
        arrays = syn.recsys_batch(cfg, shape.batch, step=shape.step,
                                  n_candidates=shape.n_candidates, seed=seed)
        return {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}

    return StepBundle(
        spec.arch_id, "recsys", shape.step, cfg, shape,
        init_params=lambda generator: deepfm.init_params(cfg, generator),
        make_state=lambda p: p, fn=fn, make_batch=make_batch)


def build_bundle(spec: ArchSpec, shape_or_name, *, reduced: bool = False,
                 device="cuda") -> StepBundle:
    """The step of one (architecture, shape) cell on ``device`` (the card
    unless the caller passes ``device="cpu"``)."""
    shape = (get_shape(spec, shape_or_name)
             if isinstance(shape_or_name, str) else shape_or_name)
    cfg = spec.reduced if reduced else spec.config
    if reduced:
        shape = reduce_shape(shape, spec.family)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_bundle: no CUDA card; pass device='cpu' "
                           "to run the plain path on the CPU")
    if spec.family == "lm":
        return _lm_bundle(spec, shape, cfg, device)
    return _recsys_bundle(spec, shape, cfg, device)
