"""TF32 arithmetic of the split-TF32 kernels (A2's ``bsr_spmm_kernel`` and
A4's f32 route), in plain torch for their emulations and plain versions.

The tensor cores read an f32 word as TF32, 10 of its 23 mantissa bits.  A
kernel that must keep f32 accuracy splits each operand ``v = hi + lo``:
``hi`` is ``v`` with its 13 low bits cleared, ``lo = v - hi`` rounded to
TF32 to nearest, and multiplies ``lo hi + hi lo + hi hi``.

One rule for the values f32 products treat specially, which both kernels
and both emulations follow (``split_whole_lo``):

- a non-finite ``v`` has ``hi`` 0 and goes to ``lo`` whole (a NaN made
  quiet), so each product of it meets the other operand's ``hi`` alone;
- a finite nonzero ``v`` below 2^-136 in magnitude, whose cleared word is
  0, has ``hi = copysign(2^-136, v)``, the least TF32 magnitude (an f32
  subnormal, which the tensor cores keep), so that its product with an
  infinite operand reads +-inf, as in f32, and not 0 * inf = NaN.

The second case costs integer work on every operand, and matters only
where an infinite value can meet a value below 2^-136.  A2 therefore takes
it only when its dense operand x holds such a value (``needs_least_hi``):
infinite tile values alone meet x's hi, which is then never below
2^-136.  What is left: inf times inf at one k meets ``hi`` 0 and reads NaN
where f32 has +-inf.
"""

from __future__ import annotations

import torch

# TF32 keeps 10 of f32's 23 mantissa bits: clearing the 13 low bits
_TF32_MASK = -(1 << 13)                            # 0xFFFFE000 as int32
# 2^-136, the least TF32 magnitude, as f32 bits
_TF32_LEAST = 1 << 13
_SIGN = -(1 << 31)                                 # 0x80000000 as int32
_F32_INF = 0x7F800000                              # inf's bits, less sign


def tf32_trunc(v: torch.Tensor) -> torch.Tensor:
    """``v`` with its 13 low mantissa bits cleared: what the tensor core
    reads of an f32 word as TF32."""
    return (v.view(torch.int32) & _TF32_MASK).view(torch.float32)


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to TF32, to nearest with ties away from zero
    (``cvt.rna.tf32.f32``); for finite ``v``."""
    return ((v.view(torch.int32) + (1 << 12)) & _TF32_MASK).view(
        torch.float32)


def tf32_hi(v: torch.Tensor) -> torch.Tensor:
    """The TF32 hi of finite f32 ``v``: ``tf32_trunc(v)``, or
    ``copysign(2^-136, v)`` where ``v`` is nonzero and that is 0."""
    u = v.view(torch.int32)
    tiny = ((u & 0x7FFFFFFF) < _TF32_LEAST) & ((u & 0x7FFFFFFF) != 0)
    return torch.where(tiny, (u & _SIGN) | _TF32_LEAST,
                       u & _TF32_MASK).view(torch.float32)


def quiet(v: torch.Tensor) -> torch.Tensor:
    """For non-finite ``v``: NaN with its top mantissa bit set, so TF32
    truncation keeps it NaN, and inf unchanged.  (A finite ``v`` with a
    non-zero mantissa is changed too: apply it where ``v`` is not finite.)"""
    u = v.view(torch.int32)
    return torch.where((u & 0x7FFFFF) != 0, u | 0x400000, u).view(
        torch.float32)


def needs_least_hi(x: torch.Tensor) -> torch.Tensor:
    """(1,) int32 on ``x``'s device, with no host read: 1 where ``x`` holds
    a non-finite value or a nonzero one below 2^-136 in magnitude (a
    product of x can then meet an infinite value through a value below
    2^-136), else 0."""
    m = x.reshape(-1).view(torch.int32) & 0x7FFFFFFF
    if not m.numel():
        return torch.zeros(1, dtype=torch.int32, device=x.device)
    lo, hi = torch.aminmax(torch.where(m == 0, _TF32_LEAST, m))
    return ((lo < _TF32_LEAST) | (hi >= _F32_INF)).to(torch.int32).reshape(1)


def split_tf32(v: torch.Tensor, least_hi: bool = True):
    """The kernels' split of f32 ``v`` into TF32 parts: ``(hi, lo,
    finite)`` with ``hi = tf32_hi(v)`` (``tf32_trunc(v)`` without
    ``least_hi``) and ``lo = tf32_rna(v - hi)`` where ``v`` is finite (0
    elsewhere)."""
    v = v.to(torch.float32).contiguous()
    finite = torch.isfinite(v)
    hi = tf32_hi(v) if least_hi else tf32_trunc(v)
    lo = torch.where(finite, tf32_rna(v - hi), 0.0)
    return hi, lo, finite


def hi_word(v: torch.Tensor) -> torch.Tensor:
    """The f32 word a kernel hands the tensor core as ``v``'s hi, which the
    tensor core reads truncated to ``split_whole_lo(v)[0]``: ``v`` itself,
    but ``copysign(2^-136, v)`` where its truncation is 0 and ``v`` is
    not, and 0 where ``v`` is not finite."""
    v = v.to(torch.float32)
    hi = tf32_hi(v)
    return torch.where(torch.isfinite(v),
                       torch.where(tf32_trunc(v) == hi, v, hi), 0.0)


def split_whole_lo(v: torch.Tensor, least_hi: bool = True):
    """The split-TF32 kernels' operand parts ``(hi, lo)``: ``split_tf32``'s
    where ``v`` is finite; a non-finite ``v`` has ``hi`` 0 and goes to
    ``lo`` whole (a NaN made quiet), so each product of it meets the other
    operand's ``hi`` alone."""
    hi, lo, finite = split_tf32(v, least_hi)
    return (torch.where(finite, hi, 0.0),
            torch.where(finite, lo, quiet(v.to(torch.float32))))
