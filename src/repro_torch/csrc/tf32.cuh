// TF32 splits of the split-TF32 kernels: A2's bsr_spmm_kernel
// (bfs_kernels.cu) and A4's f32 route, flash_fwd_tf32 and its pre-pass
// split_kv_kernel (attention_kernels.cu).  The rule is kernels/tf32.py's,
// which both kernels' emulations follow.
//
// An f32 operand v = hi + lo.  hi is an f32 word handed to the tensor core,
// which reads it as TF32 (its 13 low mantissa bits dropped); lo = v - hi,
// exact in f32, rounded to TF32 to nearest.  A product of two operands is
// lo hi + hi lo + hi hi.  Two kinds of value take another hi:
// - A non-finite v has hi 0 and goes to lo whole (a NaN made quiet), so
//   each product of it meets the other operand's hi alone.
// - A finite nonzero v below 2^-136 in magnitude truncates to 0.  Its hi is
//   copysign(2^-136, v), the least TF32 magnitude (an f32 subnormal, which
//   wgmma's TF32 keeps: tests/test_torch_cuda.py reads it on the card), so
//   its product with an infinite operand is +-inf, as in f32, not
//   0 * inf = NaN.  hi + lo is 0 or +-2^-136 for it.
// The second costs integer work on every operand; kLeast = false leaves it
// out (A2's path for an x that holds no value below 2^-136 and no
// non-finite one: then no product meets an infinite value through a value
// below 2^-136).  Left: inf times inf at one k meets a hi of 0 and reads
// NaN where f32 has +-inf.
#pragma once

#include <stdint.h>

// v rounded to TF32, to nearest with ties away from zero: cvt.rna.tf32's
// rounding in two integer operations, which cost the kernels much less than
// the conversion did; for finite v
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ bool finite_bits(uint32_t u) {
  return (u & 0x7f800000u) != 0x7f800000u;
}

// a NaN with its payload in the low 13 bits only would read as inf in TF32
__device__ __forceinline__ uint32_t quiet_bits(uint32_t u) {
  return u | ((u & 0x007fffffu) ? 0x00400000u : 0u);
}

// the TF32 hi of finite u, truncated: u with its 13 low bits cleared, or
// copysign(2^-136) where that is +-0 and u is not
// (selects, no branch: the kernels split between wgmma issues, and a
// divergent path there makes ptxas serialise them)
template <bool kLeast = true>
__device__ __forceinline__ uint32_t tf32_hi(uint32_t u) {
  const uint32_t h = u & 0xffffe000u;
  if (!kLeast) return h;
  return (((h << 1) == 0u) & ((u << 1) != 0u)) ? (h | 0x2000u) : h;
}

// the hi word of any v: v itself (the tensor core truncates it), 0 where v
// is not finite, copysign(2^-136, v) below 2^-136
template <bool kLeast = true>
__device__ __forceinline__ float hi_of(float v) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t h = kLeast && (((u & 0x7fffe000u) == 0u) & ((u << 1) != 0u))
                         ? ((u & 0x80000000u) | 0x2000u)
                         : u;
  return __uint_as_float(finite_bits(u) ? h : 0u);
}

// the TF32 lo of finite v
template <bool kLeast = true>
__device__ __forceinline__ float lo_of(float v) {
  return __uint_as_float(
      tf32_rna(v - __uint_as_float(tf32_hi<kLeast>(__float_as_uint(v)))));
}

// the lo of any v: a non-finite v whole, a NaN made quiet
template <bool kLeast = true>
__device__ __forceinline__ float lo_or_whole(float v) {
  const uint32_t u = __float_as_uint(v);
  return finite_bits(u) ? lo_of<kLeast>(v) : __uint_as_float(quiet_bits(u));
}
