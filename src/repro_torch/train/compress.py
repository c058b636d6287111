"""Gradient compression for the cross-pod all-reduce — the port of
``repro.train.compress``.

  * ``bf16``  — round gradients to bf16 and back; 2x wire bytes, no state.
  * ``topk``  — keep the entries of each leaf whose magnitude reaches the
    k-th largest (``k = max(1, int(n * k_frac))``; ties at the threshold
    keep more than k, as in the JAX package) and carry the rest in an f32
    error-feedback buffer added to the next step's gradient.

Both map trees of tensors to trees of tensors between backward and the
optimizer; ``train.trainer.make_compressed_train_step`` composes them.
"""

from __future__ import annotations

import torch

from repro_torch import tree as tr


def compress_bf16(grads):
    return tr.map_tree(lambda g: g.to(torch.bfloat16).to(g.dtype), grads)


def topk_threshold(flat_abs: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest entry of a 1-D tensor (``jax.lax.top_k(x, k)[0]
    [-1]``): the least of the k largest."""
    return torch.topk(flat_abs, k, sorted=False).values.min()


def _topk_leaf(g, ef, k_frac: float):
    g32 = g.float() + ef
    flat = g32.reshape(-1)
    n = flat.shape[0]
    k = max(1, int(n * k_frac))
    if k >= n:
        return g32.to(g.dtype), torch.zeros_like(g32)
    thresh = topk_threshold(flat.abs(), k)
    mask = (g32.abs() >= thresh).float()
    sent = g32 * mask
    new_ef = g32 - sent            # the residual accumulates locally
    return sent.to(g.dtype), new_ef


def init_error_feedback(grads_like):
    return tr.map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device), grads_like)


def compress_topk(grads, ef_state, k_frac: float = 1 / 32):
    """Returns (compressed grads, new error-feedback state)."""
    pairs = [_topk_leaf(g, e, k_frac) for g, e in
             zip(tr.leaves(grads), tr.leaves(ef_state), strict=True)]
    return (tr.unflatten(grads, [p[0] for p in pairs]),
            tr.unflatten(grads, [p[1] for p in pairs]))


def wire_bytes(grads, method: str, k_frac: float = 1 / 32) -> float:
    """Analytic wire-byte model for the pod-axis all-reduce (per step)."""
    total = sum(g.numel() for g in tr.leaves(grads))
    if method == "none":
        return total * 4.0
    if method == "bf16":
        return total * 2.0
    if method == "topk":
        return total * k_frac * 8.0  # value + index
    raise ValueError(method)
