"""TF32 arithmetic of the split-TF32 kernels (A2's ``bsr_spmm_kernel`` and
A4's f32 route), in plain torch for their emulations and plain versions.

The tensor cores read an f32 word as TF32, 10 of its 23 mantissa bits.  A
kernel that must keep f32 accuracy splits each operand ``v = hi + lo``:
``hi`` is ``v`` with its 13 low bits cleared, ``lo = v - hi`` rounded to
TF32 to nearest, and multiplies ``lo hi + hi lo + hi hi``.
"""

from __future__ import annotations

import torch

# TF32 keeps 10 of f32's 23 mantissa bits: clearing the 13 low bits
_TF32_MASK = -(1 << 13)                            # 0xFFFFE000 as int32


def tf32_trunc(v: torch.Tensor) -> torch.Tensor:
    """``v`` with its 13 low mantissa bits cleared: what the tensor core
    reads of an f32 word as TF32."""
    return (v.view(torch.int32) & _TF32_MASK).view(torch.float32)


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to TF32, to nearest with ties away from zero
    (``cvt.rna.tf32.f32``); for finite ``v``."""
    return ((v.view(torch.int32) + (1 << 12)) & _TF32_MASK).view(
        torch.float32)


def quiet(v: torch.Tensor) -> torch.Tensor:
    """For non-finite ``v``: NaN with its top mantissa bit set, so TF32
    truncation keeps it NaN, and inf unchanged.  (A finite ``v`` with a
    non-zero mantissa is changed too: apply it where ``v`` is not finite.)"""
    u = v.view(torch.int32)
    return torch.where((u & 0x7FFFFF) != 0, u | 0x400000, u).view(
        torch.float32)


def split_tf32(v: torch.Tensor):
    """The kernels' split of f32 ``v`` into TF32 parts: ``(hi, lo,
    finite)`` with ``hi = tf32_trunc(v)`` and ``lo = tf32_rna(v - hi)``
    where ``v`` is finite (0 elsewhere)."""
    v = v.to(torch.float32).contiguous()
    finite = torch.isfinite(v)
    hi = tf32_trunc(v)
    lo = torch.where(finite, tf32_rna(v - hi), 0.0)
    return hi, lo, finite


def split_whole_lo(v: torch.Tensor):
    """The split-TF32 kernels' operand parts ``(hi, lo)``: ``split_tf32``'s
    where ``v`` is finite; a non-finite ``v`` has ``hi`` 0 and goes to
    ``lo`` whole (a NaN made quiet), so each product of it meets the other
    operand's ``hi`` alone."""
    hi, lo, finite = split_tf32(v)
    return (torch.where(finite, hi, 0.0),
            torch.where(finite, lo, quiet(v.to(torch.float32))))
