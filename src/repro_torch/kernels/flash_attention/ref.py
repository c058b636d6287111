"""Plain torch attention oracle (materialized scores) with GQA, causal
and window masks — the port of ``repro.kernels.flash_attention.ref``.

It is the plain version of kernel A4: the CPU tests hold it to the JAX
package, and on the card the kernel is held to it.  The scores are one
``(B, Hq, Sq, Skv)`` f32 buffer, updated in place (mask, exp, normalize)
so that a full-width prefill holds one such buffer at a time.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(sq: int, skv: int, *, causal: bool, window: int,
                   device) -> torch.Tensor:
    """``(Sq, Skv)`` bool: key ``k`` is visible from query ``q``."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh).  f32 softmax; q head
    ``h`` reads kv head ``h // (Hq // Hkv)`` (``jnp.repeat``'s order);
    rows with no visible key are zero.  Returns q's dtype."""
    dh = q.shape[-1]
    sq, skv = q.shape[2], k.shape[2]
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s.mul_(dh ** -0.5)
    hidden = ~attention_mask(sq, skv, causal=causal, window=window,
                             device=q.device)
    s.masked_fill_(hidden, NEG_INF)
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    s.masked_fill_(hidden, 0.0)               # rows with no visible key -> 0
    l = s.sum(dim=-1, keepdim=True)
    s.div_(torch.where(l == 0, 1.0, l))
    return torch.matmul(s, v.float()).to(q.dtype)
