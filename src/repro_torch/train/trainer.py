"""Training loop: checkpoint/restart, fault injection, straggler watchdog,
deterministic resumable data order — the port of ``repro.train.trainer``.

The step function comes from ``launch.steps.build_bundle``.  Fault
tolerance contract, as in the JAX package:
  * checkpoint every ``ckpt_every`` steps and at the last (atomic,
    keep-k);
  * any exception in a step, or a non-finite loss, restores the latest
    checkpoint and replays from its step;
  * a step's batch is a function of ``seed * 1_000_003 + step``, so
    replayed steps see the same batches.

Straggler mitigation: a per-step wall-time EWMA; a step slower than
``straggler_factor`` times the EWMA (after the first three) is recorded
in ``straggler_events``.  A step is timed from before ``fault_hook`` to
after ``float(loss)``, the read that waits for the card; ``step_times``
holds every completed step's ``(step, seconds)``.

``TrainerConfig.grad_compression`` is kept as the JAX package has it:
``launch.train --compression`` sets it and nothing reads it (``Trainer``
runs ``bundle.fn``); ``make_compressed_train_step`` builds the compressed
step on its own.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state
from repro_torch.train import compress as comp
from repro_torch.train.checkpoint import CheckpointManager


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    num_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=default_ckpt_dir)
    keep: int = 3
    log_every: int = 10
    grad_compression: str = "none"      # none | bf16 | topk (read by none)
    topk_frac: float = 1 / 32
    straggler_factor: float = 3.0
    seed: int = 0


class Trainer:
    def __init__(self, bundle, tcfg: TrainerConfig,
                 opt_cfg: AdamWConfig = AdamWConfig(),
                 fault_hook: Optional[Callable[[int], None]] = None):
        if bundle.step_kind != "train":
            raise ValueError(f"Trainer runs a train bundle, not a "
                             f"{bundle.step_kind!r} one")
        self.bundle = bundle
        self.tcfg = tcfg
        self.mgr = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.fault_hook = fault_hook or (lambda step: None)
        self._step_fn = bundle.fn
        self.metrics_log = []
        self.straggler_events = []
        self.step_times = []

    # ------------------------------------------------------------- run
    def run(self, init_state=None, resume: bool = True):
        t = self.tcfg
        state = init_state
        start_step = 0
        if state is None:
            gen = torch.Generator(device=self.bundle.device).manual_seed(
                t.seed)
            state = self.bundle.make_state(self.bundle.init_params(gen))
        if resume:
            restored, step = self.mgr.restore(state)
            if restored is not None:
                state, start_step = restored, step
        ewma = None
        step = start_step
        while step < t.num_steps:
            batch = self.bundle.make_batch(seed=t.seed * 1_000_003 + step)
            t0 = time.perf_counter()
            try:
                self.fault_hook(step)
                state, metrics = self._step_fn(state, batch)
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
            except Exception as e:  # noqa: BLE001 — restart from checkpoint
                restored, ck_step = self.mgr.restore(state)
                if restored is None:
                    raise
                state = restored
                self.metrics_log.append(
                    {"step": step, "event": "restart", "error": repr(e),
                     "restored_step": ck_step})
                step = ck_step
                continue
            dt = time.perf_counter() - t0
            self.step_times.append((step, dt))
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > t.straggler_factor * ewma and step > start_step + 2:
                self.straggler_events.append({"step": step, "dt": dt,
                                              "ewma": ewma})
            step += 1
            if step % t.log_every == 0 or step == t.num_steps:
                self.metrics_log.append({"step": step, "loss": loss,
                                         "dt": dt})
            if step % t.ckpt_every == 0 or step == t.num_steps:
                self.mgr.save(step, state)
        self.mgr.wait()
        return state


def make_compressed_train_step(loss_fn, opt_cfg: AdamWConfig, method: str,
                               k_frac: float = 1 / 32):
    """Standalone compressed train step (the state carries the error
    feedback under ``topk``).  Returns (make_state, step)."""
    grad_fn = torch.func.grad_and_value(loss_fn, has_aux=True)

    def make_state(params):
        st = {"params": params, "opt": init_state(params)}
        if method == "topk":
            st["ef"] = comp.init_error_feedback(params)
        return st

    def step(state, batch):
        grads, (loss, _) = grad_fn(state["params"], batch)
        new_state = dict(state)
        if method == "bf16":
            grads = comp.compress_bf16(grads)
        elif method == "topk":
            grads, new_state["ef"] = comp.compress_topk(
                grads, state["ef"], k_frac)
        new_p, new_opt, m = apply_updates(opt_cfg, state["params"], grads,
                                          state["opt"])
        new_state.update(params=new_p, opt=new_opt)
        return new_state, {"loss": loss, **m}

    return make_state, step
