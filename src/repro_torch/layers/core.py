"""Shared layers of the LM prefill and decode paths — the port of the
parts of ``repro.layers.core`` that those steps run: ``rms_norm`` (Gemma's
``1 + weight``), ``rope`` with shared or per-sequence positions,
``swiglu``, and the decode attention.

The prefill step's attention is not here: it calls kernel A4 through
``repro_torch.kernels.flash_attention.ops.attention``.  The decode step
attends through ``chunked_attention``, which sends a query of at most 8
positions to ``decode_attention`` (a direct masked product, f32 softmax),
as the JAX module does; its chunked online-softmax scan over a cache and
``_make_flash_train`` serve the LM train step, a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


NEG_INF = -1e30


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, H, S, Dh); positions: (S,) shared or (B, S) per-sequence
    (continuous batching serves sequences at different depths)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs           # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if positions.dim() == 2:                 # (B, S, half) over the heads
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    return torch.matmul(F.silu(g) * u, w_down)


def _attn_mask(q_pos, k_pos, valid_len, causal: bool, window: int):
    mask = k_pos[None, :] < valid_len
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    if window > 0:
        mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
    return mask


def _per_batch(x) -> bool:
    return getattr(x, "ndim", 0) == 1


def decode_attention(q, k, v, *, causal: bool = True, window: int = 0,
                     q_offset=0, kv_len=None):
    """Attention of a few query positions over a whole cache: a direct
    masked product with the softmax in f32.

    q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh), Hq % Hkv == 0.
    ``q_offset``: the position of q's first row, an int, a 0-d tensor or a
    (B,) tensor (each sequence at its own depth); ``kv_len``: the valid
    cache entries, likewise (None: all ``Skv``).  A key is seen when it
    is valid, not after the query (``causal``) and less than ``window``
    positions before it (``window > 0``).  A row that sees no key gives
    0."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = dh ** -0.5
    dev = q.device
    qg = q.reshape(b, hkv, group, sq, dh)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    k_pos = torch.arange(skv, device=dev)
    if _per_batch(q_offset) or _per_batch(kv_len):
        ones = torch.ones(b, dtype=torch.int32, device=dev)
        q_off = torch.as_tensor(q_offset, device=dev) * ones
        q_pos = q_off[:, None] + torch.arange(sq, device=dev)[None, :]
        vl = torch.as_tensor(skv if kv_len is None else kv_len,
                             device=dev) * ones
        mask = k_pos[None, None, :] < vl[:, None, None]         # (B, 1, K)
        if causal:
            mask = mask & (q_pos[:, :, None] >= k_pos[None, None, :])
        if window > 0:
            mask = mask & ((q_pos[:, :, None] - k_pos[None, None, :])
                           < window)
        s = torch.where(mask[:, None, None], s, NEG_INF)
    else:
        q_pos = q_offset + torch.arange(sq, device=dev)
        vl = skv if kv_len is None else kv_len
        mask = _attn_mask(q_pos, k_pos, vl, causal, window)
        s = torch.where(mask[None, None, None], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(m > NEG_INF / 2, p, 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p / torch.where(l == 0, 1.0, l),
                     v.float())
    return o.reshape(b, hq, sq, dh).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      chunk: int = 1024, q_offset=0, kv_len=None):
    """Attention of q over a cache, by the JAX module's routing: a query
    of at most 8 positions (decode) goes to ``decode_attention``.  The
    chunked scan that serves longer queries is not ported (the LM train
    step's, ROADMAP Queue A 13.3) and raises."""
    if q.shape[2] <= 8:
        return decode_attention(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, kv_len=kv_len)
    raise NotImplementedError(f"chunked attention of {q.shape[2]} query "
                              f"positions (chunk {chunk}): a later slice "
                              f"(ROADMAP Queue A 13.3)")
