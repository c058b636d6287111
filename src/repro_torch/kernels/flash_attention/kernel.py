"""Blocked causal GQA flash attention forward (A4) — wrapper of the
hand-written CUDA kernels in ``csrc/attention_kernels.cu``, the port of
``repro.kernels.flash_attention.kernel``.

The kernels take any ``Sq, Skv >= 1`` (the TPU kernel asserts that they
divide its blocks) and visit only the key tiles the causal and window
masks leave visible.  On a CPU tensor ``flash_attention`` runs the plain
version, ``ref.attention_ref``.  On a CUDA tensor it launches the kernel
of the operands' dtype, or raises:

- bf16: ``attn_flash_fwd_bf16``, the tensor cores through ``wgmma``, fed
  by TMA (128-row q tiles; operands 16-byte aligned, as TMA needs);
- f32: ``attn_flash_fwd_f32``, split TF32 (three TF32 products a
  product, the f32 accuracy of the plain version) through ``wgmma``, fed
  by TMA (64-row q tiles), after its pre-pass ``split_kv``, which writes
  K's TF32 hi and lo and V transposed, with its lo, into scratch.

There is no other route: a bf16 call never falls back to the f32 kernel.
``flash_attention.launches`` counts every call that launches a kernel,
``launches_bf16`` and ``launches_f32`` each route's; ``split_kv.launches``
counts the pre-pass's.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (KEY_PAD, attention_ref,
                                                    split_kv_ref)

HEAD_DIMS = (32, 64, 128, 256)       # the head widths the kernels are built for
MAX_Q_TILES = 65535                  # grid.y: q tiles (bf16 128 rows, f32 64)
# dtype -> (C entry point, q rows per tile)
_ROUTES = {torch.bfloat16: ("attn_flash_fwd_bf16", 128),
           torch.float32: ("attn_flash_fwd_f32", 64)}


def check_shapes(q, k, v) -> None:
    """Raise ``ValueError`` unless q is (B, Hq, Sq, Dh) and k, v are one
    (B, Hkv, Skv, Dh) with Hq % Hkv == 0."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"attention takes q (B, Hq, Sq, Dh) and k, v "
                         f"(B, Hkv, Skv, Dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, dh = q.shape
    bk, hkv, _, dhk = k.shape
    if bk != b or dhk != dh or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}: "
                         f"batch and head width must match and Hq must be "
                         f"a multiple of Hkv")


def split_kv(k: torch.Tensor, v: torch.Tensor):
    """The f32 route's pre-pass: k, v (B, Hkv, Skv, Dh) f32 to ``(k_hi,
    k_lo, vt, vt_lo)``, ``k_hi``, ``k_lo`` shaped like k and ``vt``,
    ``vt_lo`` (B, Hkv, Dh, Skv_pad), Skv_pad the next multiple of
    ``KEY_PAD`` (``ref.split_kv_ref`` says what they hold).  On a CPU tensor the plain
    version; on a CUDA tensor ``attn_split_kv_f32``, or raises."""
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"split_kv takes k, v (B, Hkv, Skv, Dh); got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.device.type == "cpu":
        return split_kv_ref(k, v)
    b, hkv, skv, dh = k.shape
    if k.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(f"split_kv takes f32 k, v; got {k.dtype}, {v.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel is built for head widths "
                         f"{HEAD_DIMS}, not {dh}")
    dev = _build.require_cuda("split_kv", k, v)
    pad = -(-skv // KEY_PAD) * KEY_PAD
    k_hi, k_lo = torch.empty_like(k), torch.empty_like(k)
    vt = torch.empty((b, hkv, dh, pad), dtype=torch.float32, device=dev)
    vt_lo = torch.empty_like(vt)
    if k.numel():
        _build.launch("attn_split_kv_f32", dev, k.data_ptr(), v.data_ptr(),
                      k_hi.data_ptr(), k_lo.data_ptr(), vt.data_ptr(),
                      vt_lo.data_ptr(), b * hkv, skv, pad, dh)
        split_kv.launches += 1
    return k_hi, k_lo, vt, vt_lo


split_kv.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh); Hq % Hkv == 0.

    Returns (B, Hq, Sq, Dh) in q's dtype.  window > 0 keeps only keys
    with q_pos - k_pos < window.
    """
    check_shapes(q, k, v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.dtype not in _ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes q, k, v all f32 or all "
                         f"bf16; got {q.dtype}, {k.dtype}, {v.dtype}")
    entry, rows = _ROUTES[q.dtype]
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel is built for head widths "
                         f"{HEAD_DIMS}, not {dh}")
    if sq < 1 or skv < 1 or -(-sq // rows) > MAX_Q_TILES:
        raise ValueError(f"flash_attention takes 1 <= Sq <= "
                         f"{rows * MAX_Q_TILES} and Skv >= 1; got {sq}, {skv}")
    dev = _build.require_cuda("flash_attention", q, k, v)
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention: operands must be 16-byte "
                             "aligned")
    o = torch.empty_like(q)
    if not o.numel():
        return o
    if q.dtype == torch.bfloat16:
        _build.launch(entry, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      o.data_ptr(), b, hq, hkv, sq, skv, dh, int(causal),
                      window, dh ** -0.5)
        flash_attention.launches_bf16 += 1
    else:
        parts = split_kv(k, v)
        _build.launch(entry, dev, q.data_ptr(),
                      *(t.data_ptr() for t in parts), o.data_ptr(), b, hq,
                      hkv, sq, skv, parts[2].shape[-1], dh, int(causal),
                      window, dh ** -0.5)
        flash_attention.launches_f32 += 1
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
flash_attention.launches_bf16 = 0
flash_attention.launches_f32 = 0
