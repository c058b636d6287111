"""Shared layers of the LM steps — the port of ``repro.layers.core``:
``rms_norm`` (Gemma's ``1 + weight``), ``layer_norm``, ``rope`` with
shared or per-sequence positions, ``swiglu``, ``cross_entropy`` and the
attention of the decode and train steps; and ``scaled_normal``, the
weight draw of the LM inits (the JAX package's ``normal * scale`` in
f32, cast), in bounded slices.

The prefill step's attention is not here: it calls kernel A4 through
``repro_torch.kernels.flash_attention.ops.attention``.  ``chunked_attention``
routes as the JAX module does: a query of at most 8 positions (decode) to
``decode_attention`` (a direct masked product, f32 softmax); a train call
(no cache: ``q_offset == 0``, no ``kv_len``) to ``flash_train``, whose
backward recomputes each KV chunk's probabilities from the forward's
softmax statistics; any other long query to ``_attn_fwd_scan``, the
online-softmax scan over KV chunks.  These are plain PyTorch, as JAX's
are jnp: no Pallas kernel lies on the train route.
"""

from __future__ import annotations

import math

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


#: the most elements ``scaled_normal`` draws in f32 at once (256 MiB)
DRAW_ELEMS = 1 << 26


def scaled_normal(shape, scale: float, dtype: torch.dtype,
                  generator: torch.Generator) -> torch.Tensor:
    """``randn(shape) * scale`` in f32 on ``generator``'s device, cast to
    ``dtype``.  A leaf of more than ``DRAW_ELEMS`` elements is drawn in
    slices over its leading dims into the ``dtype`` leaf, so the f32
    transient stays under 256 MiB whatever the leaf (a whole yi-34b
    ``w_gate`` in f32 is 35.2 GB); a smaller leaf is one draw, as
    ``randn(shape)`` draws it."""
    dev = generator.device
    out = torch.empty(shape, dtype=dtype, device=dev)
    if dev.type == "meta":               # the dry run: nothing is drawn
        return out
    n = next(i for i in range(len(shape) + 1)
             if math.prod(shape[i:]) <= DRAW_ELEMS)
    rows = out.view(-1, *shape[n:])
    step = max(1, DRAW_ELEMS // math.prod(shape[n:]))
    for i in range(0, rows.shape[0], step):
        w = torch.randn(rows[i:i + step].shape, generator=generator,
                        device=dev)
        rows[i:i + step] = w.mul_(scale)
    return out


def _attn_mask(q_pos, k_pos, valid_len, causal: bool, window: int):
    mask = k_pos[None, :] < valid_len
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    if window > 0:
        mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
    return mask


def _per_batch(x) -> bool:
    return getattr(x, "ndim", 0) == 1


def _positions(q, skv: int, q_offset, kv_len):
    """(q_pos, valid length, per_batch): q_pos (Sq,) with a scalar valid
    length, or (B, Sq) with a (B, 1) one when ``q_offset`` or ``kv_len``
    is a (B,) tensor (each sequence at its own depth)."""
    b, sq, dev = q.shape[0], q.shape[2], q.device
    if _per_batch(q_offset) or _per_batch(kv_len):
        ones = torch.ones(b, dtype=torch.int32, device=dev)
        q_off = torch.as_tensor(q_offset, device=dev) * ones
        q_pos = q_off[:, None] + torch.arange(sq, device=dev)[None, :]
        vl = torch.as_tensor(skv if kv_len is None else kv_len,
                             device=dev) * ones
        return q_pos, vl[:, None], True
    q_pos = q_offset + torch.arange(sq, device=dev)
    return q_pos, skv if kv_len is None else kv_len, False


def _mask_scores(s, q_pos, k_pos, vl, per_batch: bool, causal: bool,
                 window: int):
    """Scores s (B, Hkv, G, Sq, K) with NEG_INF where a key is not seen:
    past the valid length, after the query (``causal``) or ``window`` or
    more positions before it (``window > 0``)."""
    if not per_batch:
        mask = _attn_mask(q_pos, k_pos, vl, causal, window)
        return torch.where(mask[None, None, None], s, NEG_INF)
    mask = k_pos[None, None, :] < vl[:, :, None]                # (B, 1, K)
    if causal:
        mask = mask & (q_pos[:, :, None] >= k_pos[None, None, :])
    if window > 0:
        mask = mask & ((q_pos[:, :, None] - k_pos[None, None, :]) < window)
    return torch.where(mask[:, None, None], s, NEG_INF)


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
    q_pos, vl, per_batch = _positions(q, skv, q_offset, kv_len)
    s = _mask_scores(s, q_pos, torch.arange(skv, device=dev), vl, per_batch,
                     causal, window)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(m > NEG_INF / 2, p, 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p / torch.where(l == 0, 1.0, l),
                     v.float())
    return o.reshape(b, hq, sq, dh).to(q.dtype)


def _attn_fwd_scan(q, k, v, q_offset, kv_len, causal: bool, window: int,
                   chunk: int):
    """Online-softmax forward over KV chunks of ``chunk`` keys; returns
    (out, m, l): out as q, the running max m and sum l (B, Hkv, G, Sq, 1)
    in f32.  A row that sees no key keeps m = NEG_INF, l = 0 and gives 0."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = dh ** -0.5
    dev = q.device
    qg = q.reshape(b, hkv, group, sq, dh).float()
    q_pos, vl, per_batch = _positions(q, skv, q_offset, kv_len)
    m = torch.full((b, hkv, group, sq, 1), NEG_INF, device=dev)
    l = torch.zeros((b, hkv, group, sq, 1), device=dev)
    acc = torch.zeros((b, hkv, group, sq, dh), device=dev)
    for j in range(skv // chunk):
        k_j = k[:, :, j * chunk:(j + 1) * chunk].float()
        v_j = v[:, :, j * chunk:(j + 1) * chunk].float()
        s = torch.einsum("bhgqd,bhcd->bhgqc", qg, k_j) * scale
        k_pos = j * chunk + torch.arange(chunk, device=dev)
        s = _mask_scores(s, q_pos, k_pos, vl, per_batch, causal, window)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        p = torch.where(m_new > NEG_INF / 2, p, 0.0)
        alpha = torch.where(m > NEG_INF / 2, torch.exp(m - m_new), 0.0)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqc,bhcd->bhgqd", p, v_j)
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)
    return out.reshape(b, hq, sq, dh).to(q.dtype), m, l


class FlashTrain(torch.autograd.Function):
    """Attention of a train call (no cache), the port of JAX's
    ``_make_flash_train`` ``custom_vjp``: the forward is the scan and keeps
    (q, k, v, out, m, l), O(S·Dh); the backward recomputes each chunk's
    probabilities ``exp(s - m) / l`` from them, in f32, in place of the
    forward's (Sq x chunk) intermediates.  ``setup_context`` is separate
    from ``forward``, so ``torch.func`` transforms go through it too."""

    @staticmethod
    def forward(q, k, v, causal: bool, window: int, chunk: int):
        return _attn_fwd_scan(q, k, v, 0, None, causal, window, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, chunk = inputs
        out, m, l = output
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.causal, ctx.window, ctx.chunk = causal, window, chunk
        ctx.mark_non_differentiable(m, l)

    @staticmethod
    def backward(ctx, do, _dm, _dl):
        q, k, v, out, m, l = ctx.saved_tensors
        chunk = ctx.chunk
        b, hq, sq, dh = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        group = hq // hkv
        scale = dh ** -0.5
        dev = q.device
        qg = q.reshape(b, hkv, group, sq, dh).float()
        dog = do.reshape(b, hkv, group, sq, dh).float()
        og = out.reshape(b, hkv, group, sq, dh).float()
        delta = (dog * og).sum(-1, keepdim=True)           # (B,Hkv,G,Sq,1)
        l_safe = torch.where(l == 0, 1.0, l)
        q_pos = torch.arange(sq, device=dev)
        dq = torch.zeros((b, hkv, group, sq, dh), device=dev)
        dk, dv = [], []
        for j in range(skv // chunk):
            k_j = k[:, :, j * chunk:(j + 1) * chunk].float()
            v_j = v[:, :, j * chunk:(j + 1) * chunk].float()
            s = torch.einsum("bhgqd,bhcd->bhgqc", qg, k_j) * scale
            k_pos = j * chunk + torch.arange(chunk, device=dev)
            mask = _attn_mask(q_pos, k_pos, skv, ctx.causal, ctx.window)
            p = torch.exp(s - m) / l_safe
            p = torch.where(mask[None, None, None], p, 0.0)
            dv.append(torch.einsum("bhgqc,bhgqd->bhcd", p, dog))
            dp = torch.einsum("bhgqd,bhcd->bhgqc", dog, v_j)
            ds = p * (dp - delta) * scale
            dq = dq + torch.einsum("bhgqc,bhcd->bhgqd", ds, k_j)
            dk.append(torch.einsum("bhgqc,bhgqd->bhcd", ds, qg))
        return (dq.reshape(b, hq, sq, dh).to(q.dtype),
                torch.cat(dk, dim=2).to(k.dtype),
                torch.cat(dv, dim=2).to(v.dtype), None, None, None)


def flash_train(q, k, v, causal: bool, window: int, chunk: int):
    """``FlashTrain``'s output alone (the statistics stay inside)."""
    return FlashTrain.apply(q, k, v, causal, window, chunk)[0]


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      chunk: int = 1024, q_offset=0, kv_len=None):
    """Online-softmax attention of q over k, v in KV chunks, routed as
    the JAX module routes it: a query of at most 8 positions to
    ``decode_attention``; a train call (``q_offset`` the int 0, no
    ``kv_len``) to ``flash_train``; any other to the scan.

    q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh), Hq % Hkv == 0;
    ``q_offset`` and ``kv_len`` as in ``decode_attention``.  ``chunk`` is
    cut to Skv and must divide it."""
    skv, sq = k.shape[2], q.shape[2]
    if sq <= 8:
        return decode_attention(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, kv_len=kv_len)
    chunk = min(chunk, skv)
    if skv % chunk:
        raise ValueError(f"chunk {chunk} does not divide {skv} keys")
    if kv_len is None and isinstance(q_offset, int) and q_offset == 0:
        return flash_train(q, k, v, causal, window, chunk)
    return _attn_fwd_scan(q, k, v, q_offset, kv_len, causal, window,
                          chunk)[0]


def layer_norm(x, weight, bias, eps: float = 1e-6):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None):
    """Mean token cross entropy in f32; logits (..., V), labels (...)
    integers; with ``mask``, the mean over the masked-in tokens (at least
    one in the divisor)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()
