"""AdamW + global-norm clipping + cosine schedule over trees of tensors —
the port of ``repro.optim.adamw``.

As in the JAX package, everything is f32: the moments whatever the
parameters' dtype, the schedule (its ``cos`` too), the bias corrections
``1 - b ** step`` on an f32 step, and the clip scale
``min(1, clip / max(gnorm, 1e-9))``.  ``global_norm`` sums the leaves in
``jax.tree.leaves``' order (``repro_torch.tree``).  Moments of another
float dtype set the arithmetic's dtype instead (an f64 twin of a step
computes in f64); ``init_state`` always makes them f32.

``apply_updates`` is functional, as JAX's: it returns new tensors and
leaves its inputs as they were.  ``apply_updates_`` computes the same
update in the state's own buffers and frees each gradient once used (the
LM train step's: at gemma3-12b's width the functional update's old and
new state and temporaries do not fit one card).  Every leaf is updated
each step, a zero gradient too: weight decay moves every row of an
embedding table.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree as tr


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32_step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay, an f32 scalar tensor (``step``: an
    int, a float or a tensor)."""
    step = _f32_step(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(params) -> dict:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tr.leaves(params)[0].device
    return {"m": tr.map_tree(zeros32, params),
            "v": tr.map_tree(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, each summed in f32 (f64
    for an f64 leaf), the leaf sums added in leaf order."""
    return torch.sqrt(sum(l.to(_acc_dtype(l)).square().sum()
                          for l in tr.leaves(tree)))


def bias_correction(beta: float, step: torch.Tensor) -> torch.Tensor:
    """``1 - beta ** step``, in ``step``'s dtype."""
    return 1 - torch.pow(beta, step)


def _scalars(cfg: AdamWConfig, grads, state, acc: torch.dtype) -> dict:
    """The step's scalars: the new step, the grad norm and clip scale,
    the learning rate and the bias corrections."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    lr = schedule(cfg, step)
    step_f = step.to(torch.float32).to(acc)
    return {"step": step, "gnorm": gnorm, "lr": lr,
            "scale": torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                                 max=1.0).to(acc),
            "b1c": bias_correction(cfg.b1, step_f),
            "b2c": bias_correction(cfg.b2, step_f), "lr_acc": lr.to(acc)}


def apply_updates(cfg: AdamWConfig, params, grads, state):
    """Returns (new_params, new_state, metrics)."""
    flat_p = tr.leaves(params)
    flat_g = tr.leaves(grads)
    flat_m = tr.leaves(state["m"])
    flat_v = tr.leaves(state["v"])
    acc = flat_m[0].dtype
    sc = _scalars(cfg, grads, state, acc)
    step, gnorm, lr, scale = sc["step"], sc["gnorm"], sc["lr"], sc["scale"]
    b1c, b2c, lr_acc = sc["b1c"], sc["b2c"], sc["lr_acc"]

    def upd(p, g, m, v):
        g = g.to(acc) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g.square()
        mhat = m / b1c
        vhat = v / b2c
        p32 = p.to(acc)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        return (p32 - lr_acc * delta).to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m,
                                                 flat_v)]
    new_p = tr.unflatten(params, [o[0] for o in out])
    new_m = tr.unflatten(params, [o[1] for o in out])
    new_v = tr.unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics


@torch.no_grad()
def apply_updates_(cfg: AdamWConfig, params, grads: list, state):
    """``apply_updates`` in the state's own buffers: the same leaves, the
    same formula and order of operations, so on the CPU the result is
    bitwise ``apply_updates``'.  Each op rounds once and none passes
    ``alpha=`` (a CUDA ``add`` with ``alpha`` may fuse ``alpha * b + a``
    into one FMA), so on the card it is bitwise too.

    ``grads``: the gradients in leaf order, a list this function owns:
    each entry is set to None once used, which frees it when the caller
    keeps no other reference.  Writes each leaf of ``params``, ``m`` and
    ``v`` in place and returns (params, {"m", "v", "step"}, metrics), the
    step a new tensor."""
    flat_p = tr.leaves(params)
    flat_m = tr.leaves(state["m"])
    flat_v = tr.leaves(state["v"])
    acc = flat_m[0].dtype
    sc = _scalars(cfg, grads, state, acc)
    for i, (p, m, v) in enumerate(zip(flat_p, flat_m, flat_v, strict=True)):
        g = grads[i].to(acc) * sc["scale"]
        grads[i] = None
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        del g
        den = (v / sc["b2c"]).sqrt_().add_(cfg.eps)
        delta = (m / sc["b1c"]).div_(den)
        del den
        delta.add_(p.to(acc, copy=True).mul_(cfg.weight_decay))
        delta.mul_(sc["lr_acc"])
        p.copy_(p.to(acc, copy=True).sub_(delta))
        del delta
    metrics = {"grad_norm": sc["gnorm"], "lr": sc["lr"]}
    return params, {"m": state["m"], "v": state["v"],
                    "step": sc["step"]}, metrics
