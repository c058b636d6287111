"""Plain torch attention oracle (materialized scores) with GQA, causal
and window masks — the port of ``repro.kernels.flash_attention.ref``.

It is the plain version of kernel A4: the CPU tests hold it to the JAX
package, and on the card the kernel is held to it.  Beside it sit the
plain version of the f32 route's pre-pass (``split_kv_ref``) and an
emulation of that route's split-TF32 arithmetic (``attention_split_ref``,
for the tests).  The scores are one
``(B, Hq, Sq, Skv)`` f32 buffer, updated in place (mask, exp, normalize)
so that a full-width prefill holds one such buffer at a time.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.tf32 import hi_word, split_tf32, split_whole_lo

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


# The f32 route's pre-pass stores each group of 8 keys of V^T in this
# order, so the S accumulator fragment is the A operand of the PV product
# as it lies (attention_kernels.cu, the f32 note); V^T's key axis is
# padded to a multiple of KEY_PAD with zeros.
KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
KEY_PAD = 32
Q_TILE_F32 = 64        # q rows a CTA of the f32 route
KV_TILE_F32 = 64       # keys a kv tile
LOG2E = 1.4426950408889634


def key_positions(skv_pad: int, device=None) -> torch.Tensor:
    """``(Skv_pad,)`` long: the key stored at each position of V^T."""
    pos = torch.arange(skv_pad, device=device)
    order = torch.tensor(KEY_ORDER, device=device)
    return pos - pos % 8 + order[pos % 8]


def split_kv_ref(k: torch.Tensor, v: torch.Tensor):
    """The plain version of the f32 route's pre-pass: ``(k_hi, k_lo, vt,
    vt_lo)``, ``k_hi``, ``k_lo`` shaped like ``k`` and ``vt``, ``vt_lo``
    (B, Hkv, Dh, Skv_pad).  ``k_hi`` is k and ``k_lo`` its TF32 lo; ``vt``
    is V and ``vt_lo`` its lo, transposed, keys in ``key_positions`` order,
    zero past Skv.  Each value is split by ``tf32.split_whole_lo``'s rule:
    hi is ``tf32.hi_word``, the f32 word (which the tensor core reads
    truncated to TF32) but 0 where it is not finite and ``copysign(2^-136,
    v)`` below 2^-136; lo is ``split_whole_lo``'s, a non-finite value
    whole (a NaN made quiet)."""
    b, hkv, skv, dh = k.shape
    pad = -(-skv // KEY_PAD) * KEY_PAD
    k, v = k.float(), v.float()
    vp = torch.zeros((b, hkv, pad, dh), dtype=torch.float32, device=v.device)
    vp[:, :, :skv] = v
    vp = vp[:, :, key_positions(pad, v.device)].transpose(-1, -2)
    k_lo, vt_lo = (split_whole_lo(x)[1] for x in (k, vp))
    k_hi, vt = (hi_word(x) for x in (k, vp))
    return (k_hi.contiguous(), k_lo.contiguous(), vt.contiguous(),
            vt_lo.contiguous())


def _live(m: torch.Tensor) -> torch.Tensor:
    return ~(m <= NEG_INF / 2)                  # NaN counts as live


def attention_split_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        products: int = 3):
    """Emulation of the f32 route's arithmetic (for the tests), f32 in and
    out.  Per q tile of 64 rows, the kv tiles of 64 keys it can see, tile
    ``t`` on consumer ``t % 2``; each consumer's online softmax in base 2
    (scale * log2(e) folded in); S one 32-column Dh panel at a time, ``lo
    hi + hi lo + hi hi`` of TF32 parts summed in f32 and joined to S; P
    split into TF32 hi and lo and multiplied with V's parts the same way,
    32 keys at a time, each joined to O; the two consumers' (m, l, O)
    merged at the end.  q, k and v are split as the kernel splits them
    (``split_whole_lo``: a non-finite value in lo whole, hi 0; a value
    below 2^-136 with hi ``copysign(2^-136, v)``), and P as well.
    ``products=1`` keeps only ``hi hi``: one pass of TF32."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale_log2 = float(torch.tensor(dh ** -0.5, dtype=torch.float32)
                       * torch.tensor(LOG2E, dtype=torch.float32))

    def parts(x, split=split_whole_lo):
        hi, lo = split(x)[:2]
        return (hi, lo if products == 3 else torch.zeros_like(lo))

    def product(a, b_):
        """``a @ b_`` from TF32 parts, the small products first."""
        (ah, al), (bh, bl) = a, b_
        y = torch.matmul(al, bh)
        y += torch.matmul(ah, bl)
        y += torch.matmul(ah, bh)
        return y

    qs = parts(q.float())
    ks = parts(k.float().repeat_interleave(group, dim=1))
    vs = parts(v.float().repeat_interleave(group, dim=1))
    out = torch.zeros((b, hq, sq, dh), dtype=torch.float32)
    visible = attention_mask(sq, skv, causal=causal, window=window,
                             device=q.device)
    for q0 in range(0, sq, Q_TILE_F32):
        rows = slice(q0, min(q0 + Q_TILE_F32, sq))
        n = rows.stop - q0
        k_end = min(skv, rows.stop) if causal else skv
        k_begin = (max(0, q0 - window + 1) // KV_TILE_F32 * KV_TILE_F32
                   if window > 0 else 0)
        n_tiles = max(0, -(-(k_end - k_begin) // KV_TILE_F32))
        state = [[torch.full((b, hq, n), NEG_INF), torch.zeros((b, hq, n)),
                  torch.zeros((b, hq, n, dh))] for _ in range(2)]
        for t in range(n_tiles):
            m, l, o = state[t % 2]
            keys = slice(k_begin + t * KV_TILE_F32,
                         min(k_begin + (t + 1) * KV_TILE_F32, skv))
            s = None
            for c in range(0, dh, 32):
                sp = product(tuple(x[:, :, rows, c:c + 32] for x in qs),
                             tuple(x[:, :, keys, c:c + 32].transpose(-1, -2)
                                   for x in ks))
                s = sp if s is None else s + sp
            s = s.masked_fill(~visible[rows, keys], float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1) * scale_log2)
            alpha = torch.where(_live(m), torch.exp2(m - m_new), 0.0)
            arg = (s.double() * scale_log2 - m_new.double()[..., None]).float()
            p = torch.where(_live(m_new)[..., None], torch.exp2(arg), 0.0)
            l = alpha * l + p.sum(dim=-1)
            o = o * alpha[..., None]
            ps = parts(p, split_tf32)
            for k0 in range(0, p.shape[-1], 32):
                o = o + product(tuple(x[..., k0:k0 + 32] for x in ps),
                                tuple(x[:, :, keys][:, :, k0:k0 + 32]
                                      for x in vs))
            state[t % 2] = [m_new, l, o]
        (m0, l0, o0), (m1, l1, o1) = state
        m = torch.maximum(m0, m1)
        a0 = torch.where(_live(m0), torch.exp2(m0 - m), 0.0)
        a1 = torch.where(_live(m1), torch.exp2(m1 - m), 0.0)
        l = a0 * l0 + a1 * l1
        l = torch.where(l == 0, 1.0, l)
        out[:, :, rows] = (a0[..., None] * o0 + a1[..., None] * o1) / l[..., None]
    return out
