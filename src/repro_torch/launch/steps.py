"""Step builder: (architecture x shape) -> step function and inputs — the
port of ``repro.launch.steps`` for the LM prefill step.

``build_bundle(spec, "prefill_32k", reduced=..., device=...)`` gives
``init_params(generator)``, ``make_batch(seed)`` (a prompt of ``seq_len``
tokens on the device, as in the JAX bundle) and ``fn(params, batch)``, which
returns ``(last-token logits, cache)``.  Other families and steps are
later slices and raise ``NotImplementedError``.  The JAX bundle's
``input_specs`` (abstract inputs for the XLA dry-run) has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchSpec, LMShape, get_shape
from repro_torch.data import synthetic as syn
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class StepBundle:
    arch_id: str
    family: str
    step_kind: str           # prefill
    cfg: Any
    shape: Any
    init_params: Callable    # torch.Generator -> params
    make_state: Callable     # params -> state (the params, for serving)
    fn: Callable             # (state, batch, use_kernel=True) -> outputs
    make_batch: Callable     # (seed) -> batch of tensors on the device


def reduce_shape(shape, family: str):
    """Tiny same-structure shape for CPU smoke tests."""
    if family == "lm":
        return LMShape(shape.name, shape.step, seq_len=32, global_batch=2)
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


def build_bundle(spec: ArchSpec, shape_or_name, *, reduced: bool = False,
                 device="cuda") -> StepBundle:
    """The step of one (architecture, shape) cell on ``device`` (the card
    unless the caller passes ``device="cpu"``)."""
    shape = (get_shape(spec, shape_or_name)
             if isinstance(shape_or_name, str) else shape_or_name)
    cfg = spec.reduced if reduced else spec.config
    if reduced:
        shape = reduce_shape(shape, spec.family)
    if spec.family != "lm":
        raise NotImplementedError(f"family {spec.family!r}: later slice")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_bundle: no CUDA card; pass device='cpu' "
                           "to run the plain path on the CPU")
    return _lm_bundle(spec, shape, cfg, device)
