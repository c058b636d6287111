// Hand-written Hopper (sm_90a) kernels of the dense 1-D BFS main path.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  Each
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  Packed frontier words are uint32 here and int32 (same bits) on
// the torch side.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <initializer_list>

#include "tf32.cuh"

namespace {

constexpr int32_t kInf = 1 << 30;  // frontier.INF: unreached
constexpr int kThreads = 256;

// ------------------------------------------------------------ shared helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// A1 fold_update: replaces the Pallas kernel _fold_update_kernel
// (src/repro/kernels/fold_update.py:57, launched by _fold_update_pallas).
//
// Fused dense tail: bit-test each merged candidate word against the 32 dist
// rows it covers (LSB-first); a row is new if its bit is set and its dist is
// INF; new rows take `level`; emit the new mask and the re-packed new words.
//
// Bound on the H100: memory.  Per level it moves 4+4+1 bytes per (row,
// source) plus 8 bytes per (word, source): ~9.25 bytes per element and no
// arithmetic to speak of.  Design: one thread per (word, source) element,
// neighbouring threads on neighbouring sources, so each of the 32 dist rows
// a warp reads is one coalesced 128-byte line; every byte is touched once.
// The TPU version pads dist to 32*W rows with INF; here the pad rows
// (m .. 32*W) are neither read nor written, by a bounds check.  dist_out may
// alias dist (in-place update): each element is read and then written by the
// same thread.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
fold_update_kernel(const uint32_t* __restrict__ words, const int32_t* dist,
                   int32_t* dist_out, uint8_t* __restrict__ new_out,
                   uint32_t* __restrict__ words_out, int64_t batch, int64_t w,
                   int64_t m, int64_t s, int32_t level) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= batch * w * s) return;
  const int64_t col = t % s;
  const int64_t bw = t / s;       // b * w + word index
  const int64_t wi = bw % w;
  const int64_t b = bw / w;
  const uint32_t word = words[t];
  const int64_t row0 = wi * 32;
  const int64_t base = b * m * s + col;
  const int64_t left = m - row0;
  const int nrows = left < 32 ? (int)left : 32;
  uint32_t packed = 0;
  for (int i = 0; i < nrows; ++i) {
    const int64_t off = base + (row0 + i) * s;
    const int32_t d = dist[off];
    const bool nv = ((word >> i) & 1u) && d == kInf;
    dist_out[off] = nv ? level : d;
    new_out[off] = nv ? 1 : 0;
    packed |= (uint32_t)nv << i;
  }
  words_out[t] = packed;
}

// ---------------------------------------------------------------------------
// A2 bsr_spmm: replaces the Pallas kernel _spmm_kernel
// (src/repro/kernels/bsr_spmm/kernel.py:38, launched by bsr_spmm at :78).
//
// Y = A @ X with A in block-CSR: K dense 128x128 f32 tiles sorted by block
// row, a block-row pointer `row_ptr` (CSR indptr over block rows, built once
// when the caller compiles its graph) and each tile's block column.  X is
// (n_x_rows, d) f32 and Y (n_block_rows * 128, d) f32, both row-major, d any
// width.  A block row with no tile is written as zeros.
//
// Bound on the H100: bytes.  Every tile is read once, 64 KiB, against
// 2 * 128 * 128 * d operations; at d = 64 (path 2: 142,452 tiles, 9.39 GB
// with x and y) the bytes take 2.80 ms at 3.35 TB/s.  Plain f32 FMA on the
// CUDA cores would take 4.46 ms at 67 TFLOP/s: no CUDA-core design reaches
// the memory floor, so the products run on the tensor cores, which take f32
// only as TF32 (10 mantissa bits).  To keep f32 accuracy each operand is
// split, v = hi + lo: hi is v with its 13 low mantissa bits cleared (what
// the tensor core reads of an f32 word) and lo = v - hi, exact in f32 and
// rounded to TF32 (to nearest).  Three TF32 products, lo_a hi_x + hi_a lo_x +
// hi_a hi_x, the small ones first, accumulate in f32 ("3xTF32"); the
// dropped lo_a lo_x term is below 2^-20 of |a x|.  On 0/1 operands every lo
// is 0 and every sum an exact integer, as the plain f32 version's.  The
// three products take 1.81 ms at the TF32 peak (495 TFLOP/s), under the
// byte bound.
//
// Layout.  wgmma takes TF32 operands K-major only, so a CTA computes
// Y^T = X^T A^T for one (block row, 64 columns of X): M = 64 columns of X,
// N = 128 tile rows, K = 128 tile columns, wgmma m64n128k8.  A row-major
// tile [row][col] is then the K-major B operand as it lies in memory: TMA
// loads it in 32-column panels (128 rows x 128 bytes, 16 KiB, 128-byte
// swizzle), the tile's hi read straight from the panel.  The tile's lo goes
// to a second 16 KiB buffer, written by the consumer warps after the panel
// lands (fence.proxy.async, then a warpgroup barrier, before wgmma reads
// it).  X's 32 x 64 block is the register A operand: read from global
// memory (x is 25.6 MB at path 2 and stays in L2, evict_last; tiles stream
// past it, evict_first) a panel ahead, split into hi and lo in registers.
// Fragment row m of the A operand (and of the accumulator) is
// X column 16 (m / 16) + 2 (m % 8) + (m % 16) / 8, so a thread's two rows
// are two adjacent columns: X loads and Y stores are 8-byte pairs, each
// warp's store one 64-byte run of four Y rows, with no transpose.
//
// Schedule.  A CTA is two consumer warpgroups and a producer warpgroup
// (setmaxnreg: 232 registers a consumer thread, 40 a producer's), one CTA
// an SM, persistent.  The wrapper lists the (block row, 64-column) items
// by tile count, largest first (kernel.py bsr_spmm_work); consumer w of
// CTA c takes items 2 c + w, 2 (c + grid) + w, ...  For each consumer one
// producer thread keeps its ring of kStages panels full (mbarrier full /
// empty pairs).  The consumer issues a panel's 12 wgmma (three products of
// four k8 steps) into a panel accumulator; while they run it loads X for
// the next panel and writes the next panel's lo (kLoBufs buffers, so no
// warp overwrites a lo that another warp's products may still read); then
// it waits, adds, and frees the stage.  A ring of 3 panels and 3 lo
// buffers (192 KB a CTA) ran fastest of the depths tried.  The tensor
// core adds each k8 step into its accumulator with truncation, about
// 2^-23 of the accumulator a step; three steps a k8 step, summed over a
// long block row, that missed the f32 tolerance of the card tests on
// randn operands.  So each panel's products start from zero and join the
// item's sum in IEEE f32 adds: the truncation is relative to one panel's
// sum.  Each output block belongs to one consumer and sums its tiles in
// tile order: Y is the same, bit for bit, on every run, with no atomics.
// Loads and stores at the ragged d edge are predicated, not branched, so
// ptxas keeps the wgmma pipelined (a divergent path around them
// serialised it).
//
// Non-finite and tiny values, by tf32.cuh's rule (kernels/tf32.py's): a
// non-finite x or tile value has hi 0 and goes to lo whole (NaN made quiet,
// so TF32's truncation keeps it NaN), a tile value's place in the panel
// written with 0; a nonzero value below 2^-136 has hi copysign(2^-136),
// written into the panel likewise.  That second part is integer work on
// each of a panel's values, on the consumers' critical path: on an H100 it
// doubled the kernel's time (PERF.md §6).  It matters only where an
// infinite value meets a value below 2^-136, which needs such a value or a
// non-finite one in x (an infinite tile value meets x's hi alone).  So the
// kernel is built twice, with and without it (kLeast), both are launched,
// and the one the wrapper's device flag (tf32.needs_least_hi(x)) does not
// pick returns at once.  So inf and NaN in x, or in the tiles, give the
// plain version's result, also against a value below 2^-136 (2^-140
// against +-inf reads +-inf on the H100, tests/test_torch_cuda.py), except
// inf in a tile against inf in x at the same k, which gives NaN where the
// plain product gives inf.
// ---------------------------------------------------------------------------
namespace spmm {

constexpr int kB = 128;                     // tile rows == tile columns
constexpr int kPanel = 32;                  // tile columns a panel
constexpr int kPanels = kB / kPanel;
constexpr int kPanelBytes = kB * kPanel * 4;
constexpr int kDT = 64;                     // X columns an item (wgmma M)
constexpr int kStages = 3;                  // panels in its ring a consumer
constexpr int kLoBufs = 3;                  // lo buffers a consumer
constexpr int kConsumers = 2;               // consumer warpgroups a CTA
constexpr int kThreads = 128 * (kConsumers + 1);   // and the producers'
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;          // 40 + 2 * 232 <= 3 * 168
// a consumer's shared memory: its ring of panels, then its lo buffers
constexpr int kRingBytes = (kStages + kLoBufs) * kPanelBytes;
constexpr int kBarOff = kConsumers * kRingBytes;    // full[], empty[] each
constexpr int kSmem = 1024 + kBarOff + kConsumers * 16 * kStages;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "l"(policy)
      : "memory");
}

// wgmma shared-memory matrix descriptor: K-major, 128-byte swizzle, rows
// 128 bytes apart, 8-row groups 1024 apart (the leading offset is unused)
__device__ __forceinline__ uint64_t panel_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// x's two A operands: hi (for the tile's lo and hi) and lo (for the tile's
// hi), by tf32.cuh's rule
template <bool kLeast>
__device__ __forceinline__ void split_x(float v, uint32_t& p, uint32_t& q) {
  const uint32_t u = __float_as_uint(v);
  p = finite_bits(u) ? tf32_hi<kLeast>(u) : 0u;
  q = __float_as_uint(lo_or_whole<kLeast>(v));
}

// a chunk holding a value whose hi is not its own word (a non-finite value,
// or one below 2^-136) is written back with hi_of in its place (the panel
// is the tiles' hi): predicated, so the loop around the products has no
// divergent branch
template <bool kLeast>
__device__ __forceinline__ void store_hi(uint32_t addr, float4 v) {
  const float4 h = make_float4(hi_of<kLeast>(v.x), hi_of<kLeast>(v.y),
                               hi_of<kLeast>(v.z), hi_of<kLeast>(v.w));
  const bool same = __float_as_uint(h.x) == __float_as_uint(v.x) &&
                    __float_as_uint(h.y) == __float_as_uint(v.y) &&
                    __float_as_uint(h.z) == __float_as_uint(v.z) &&
                    __float_as_uint(h.w) == __float_as_uint(v.w);
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.b32 p, %5, 0;\n"
      "@p st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n}\n" ::"r"(addr),
      "f"(h.x), "f"(h.y), "f"(h.z), "f"(h.w), "r"((int)same)
      : "memory");
}

#define F8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (+)= A B, m64n128k8 TF32: A (64 x 8) four registers a thread, B
// (8 x 128) K-major in shared memory; d the 64 x 128 f32 fragment, 64 a
// thread.  accumulate = 0 writes A B over d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t* a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24),
        F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

#undef F8

// X rows row0 .. row0 + 31 of this thread's fragment: for k8 step kk,
// rows r = row0 + 8 kk + q and r + 4, columns c and c + 1, 0 past d.  An
// 8-byte load where `vec` (d even, x 8-byte aligned); predicated loads,
// no branch.
__device__ __forceinline__ void load_x(float (&v)[16], const float* x,
                                       int64_t row0, int64_t c, int64_t d,
                                       int vec, int q, uint64_t policy) {
  const int in0 = c < d, in1 = c + 1 < d;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* p = x + (row0 + 8 * kk + q + 4 * h) * d + c;
      float a, b;
      if (vec) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n"
            "mov.f32 %0, 0f00000000;\nmov.f32 %1, 0f00000000;\n"
            "@p ld.global.L2::cache_hint.v2.f32 {%0, %1}, [%2], %4;\n}\n"
            : "=f"(a), "=f"(b)
            : "l"(p), "r"(in0), "l"(policy));
      } else {
        asm volatile(
            "{\n.reg .pred p, r;\nsetp.ne.b32 p, %3, 0;\n"
            "setp.ne.b32 r, %4, 0;\n"
            "mov.f32 %0, 0f00000000;\nmov.f32 %1, 0f00000000;\n"
            "@p ld.global.L2::cache_hint.f32 %0, [%2], %5;\n"
            "@r ld.global.L2::cache_hint.f32 %1, [%2+4], %5;\n}\n"
            : "=f"(a), "=f"(b)
            : "l"(p), "r"(in0), "r"(in1), "l"(policy));
      }
      v[4 * kk + 2 * h] = a;
      v[4 * kk + 2 * h + 1] = b;
    }
}

// Y[row][c], Y[row][c + 1] where inside d; predicated, no branch
__device__ __forceinline__ void store_y(float* out, float a, float b,
                                        int64_t c, int64_t d, int vec) {
  const int in0 = c < d, in1 = c + 1 < d;
  if (vec)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n"
        "@p st.global.v2.f32 [%0], {%1, %2};\n}\n" ::"l"(out),
        "f"(a), "f"(b), "r"(in0)
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred p, r;\nsetp.ne.b32 p, %3, 0;\nsetp.ne.b32 r, %4, 0;\n"
        "@p st.global.f32 [%0], %1;\n@r st.global.f32 [%0+4], %2;\n}\n" ::"l"(
            out),
        "f"(a), "f"(b), "r"(in0), "r"(in1)
        : "memory");
}

// a value every thread of the warp holds, as the compiler can see it
__device__ __forceinline__ int32_t uniform(int32_t v) {
  return __shfl_sync(0xffffffffu, v, 0);
}

// kLeast: tf32.cuh's 2^-136 hi for values below 2^-136.  Both are launched;
// the one that *least (the wrapper's flag, tf32.needs_least_hi(x)) does not
// pick returns at once.
template <bool kLeast>
__global__ void __launch_bounds__(kThreads, 1)
bsr_spmm_kernel(const __grid_constant__ CUtensorMap tm_tiles,
                const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ block_cols,
                const int32_t* __restrict__ work, const float* __restrict__ x,
                float* __restrict__ y, int64_t n_items, int64_t n_dt,
                int64_t d, int vec, int evict_first,
                const int32_t* __restrict__ least) {
  if ((*least != 0) != kLeast) return;
  extern __shared__ __align__(1024) uint8_t spmm_smem[];
  const uint32_t raw0 = smem_u32(spmm_smem);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  uint8_t* base_ptr = spmm_smem + (base - raw0);
  const uint32_t bar = base + kBarOff;
  // consumer w's barriers: full[s], empty[s]
  auto full = [&](int w, int s) { return bar + 8 * (2 * kStages * w + s); };
  auto empty = [&](int w, int s) {
    return bar + 8 * (2 * kStages * w + kStages + s);
  };

  if (threadIdx.x == 0) {
    for (int w = 0; w < kConsumers; ++w)
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full(w, s), 1);
        mbar_init(empty(w, s), 4);            // one arrival a consumer warp
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // consumer w of CTA c takes items kConsumers c + w, then a grid's
  // consumers further on
  const int64_t stride = (int64_t)gridDim.x * kConsumers;
  const int wg = uniform(threadIdx.x / 128);
  if (wg == kConsumers) {
    // ----------------------------------------------------------- producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int w = (threadIdx.x / 32) % 4;     // the consumer it feeds
    if (w < kConsumers && threadIdx.x % 32 == 0) {
      uint64_t policy;
      if (evict_first)   // tiles are read once
        asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                     : "=l"(policy));
      else               // the row's next column tile reads them again
        asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"
                     : "=l"(policy));
      const uint32_t ring = base + w * kRingBytes;
      uint32_t g = 0;                         // panels issued
      for (int64_t it = (int64_t)blockIdx.x * kConsumers + w; it < n_items;
           it += stride) {
        const int64_t br = work[it] / n_dt;
        const int32_t t1 = row_ptr[br + 1];
        for (int32_t t = row_ptr[br]; t < t1; ++t)
          for (int p = 0; p < kPanels; ++p, ++g) {
            const int s = g % kStages;
            mbar_wait(empty(w, s), ((g / kStages) & 1) ^ 1);
            mbar_expect_tx(full(w, s), kPanelBytes);
            tma_load(ring + s * kPanelBytes, &tm_tiles, full(w, s),
                     p * kPanel, t * kB, policy);
          }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int q = lane % 4;
    const int cfrag = 16 * warp + 2 * (lane / 4);  // this thread's columns
    const uint32_t ring = base + wg * kRingBytes;
    uint64_t xpolicy;
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
                 : "=l"(xpolicy));
    float pacc[64];                           // one panel's products
#pragma unroll
    for (int i = 0; i < 64; ++i) pacc[i] = 0.f;
    uint32_t g = 0;                           // panels consumed

    // Panel g's lo, 16-byte chunk by chunk (the swizzle moves whole
    // chunks, so lo lands in the layout the panel has), once it has landed;
    // then a barrier, so the products may read it.
    auto lo_pass = [&](uint32_t g) {
      const int s = g % kStages;
      const uint32_t raw = ring + s * kPanelBytes;
      const uint32_t lo = ring + (kStages + g % kLoBufs) * kPanelBytes;
      mbar_wait(full(wg, s), (g / kStages) & 1);
      const float4* rp =
          reinterpret_cast<const float4*>(base_ptr + (raw - base));
      float4* lp = reinterpret_cast<float4*>(base_ptr + (lo - base));
#pragma unroll
      for (int m = 0; m < kPanelBytes / 16 / 128; ++m) {
        const int i = tid + 128 * m;
        const float4 v = rp[i];
        lp[i] = make_float4(
            lo_or_whole<kLeast>(v.x), lo_or_whole<kLeast>(v.y),
            lo_or_whole<kLeast>(v.z), lo_or_whole<kLeast>(v.w));
        store_hi<kLeast>(raw + 16 * i, v);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    };

    for (int64_t it = (int64_t)blockIdx.x * kConsumers + wg; it < n_items;
         it += stride) {
      const int32_t wi = uniform(work[it]);
      const int64_t br = wi / n_dt;
      const int64_t c = (wi % n_dt) * kDT + cfrag;
      const int32_t t0 = uniform(row_ptr[br]), t1 = uniform(row_ptr[br + 1]);
      const int32_t n = kPanels * (t1 - t0);  // the item's panels
      // the X rows of the item's panel j
      auto xrow = [&](int32_t j) {
        return (int64_t)uniform(block_cols[t0 + j / kPanels]) * kB +
               kPanel * (j % kPanels);
      };
      float acc[64];                          // the item's sum
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      float xr[16];
      if (n > 0) {
        load_x(xr, x, xrow(0), c, d, vec, q, xpolicy);
        lo_pass(g);
      }
      // Panel j's products run while panel j + 1's X is loaded and its lo
      // written; three lo buffers, so a warp writing panel j + 1's never
      // meets a product of panel j - 2 that another warp still waits on.
      for (int32_t j = 0; j < n; ++j, ++g) {
        const int s = g % kStages;
        const uint32_t raw = ring + s * kPanelBytes;
        const uint32_t lo = ring + (kStages + g % kLoBufs) * kPanelBytes;
        uint32_t ap[16], aq[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) split_x<kLeast>(xr[i], ap[i], aq[i]);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_tf32(pacc, ap + 4 * kk, panel_desc(lo + 32 * kk), kk > 0);
          wgmma_tf32(pacc, aq + 4 * kk, panel_desc(raw + 32 * kk), 1);
          wgmma_tf32(pacc, ap + 4 * kk, panel_desc(raw + 32 * kk), 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        if (j + 1 < n) {
          load_x(xr, x, xrow(j + 1), c, d, vec, q, xpolicy);
          lo_pass(g + 1);
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        // the products read pacc and the A registers until the wait
#pragma unroll
        for (int i = 0; i < 64; ++i)
          asm volatile("" : "+f"(pacc[i])::"memory");
#pragma unroll
        for (int i = 0; i < 16; ++i)
          asm volatile("" ::"r"(ap[i]), "r"(aq[i]) : "memory");
        // The tensor core adds each k8 step's products into pacc and
        // truncates; a panel's sum joins the item's in IEEE f32 adds, so
        // the truncation scales with a panel's sum, not the item's.
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += pacc[i];
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(wg, s));
      }

      // accumulator (m = 16 warp + lane / 4 + 8 h, n = 8 j + 2 q + e) is
      // Y[128 br + n][c + h]: the pair (h = 0, 1) is two adjacent columns
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          store_y(y + (br * kB + 8 * j + 2 * q + e) * d + c, acc[4 * j + e],
                  acc[4 * j + 2 + e], c, d, vec);
    }
  }
}

}  // namespace spmm

// ---------------------------------------------------------------------------
// A3 bitpack: replaces the Pallas kernel _bitpack_kernel
// (src/repro/kernels/bsr_spmm/kernel.py:100, launched by bitpack_words).
//
// Pack a (32*W, S) f32 mask (> 0) into (W, S) words, bit i = row i of the
// word's 32-row group (LSB-first, frontier.pack_bits layout).
//
// Bound on the H100: memory (4 bytes read per mask element, 1/8 byte
// written), and small next to A2's tile reads.  Design: one thread per
// (word, source), neighbouring threads on neighbouring sources, so each of
// the 32 rows is a coalesced load; the word is built in a register and
// stored once.  Fusing it into A2's epilogue is a later change.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
bitpack_kernel(const float* __restrict__ mask, uint32_t* __restrict__ out,
               int64_t w, int64_t s) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= w * s) return;
  const int64_t col = t % s;
  const int64_t wi = t / s;
  const float* p = mask + wi * 32 * s + col;
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) word |= (uint32_t)(p[i * s] > 0.f) << i;
  out[t] = word;
}

// ---------------------------------------------------------------------------
// bsr_expand_bits: the engine's expansion.  On the engine's use_kernel path
// it replaces both Pallas kernels of the JAX expansion, _spmm_kernel
// (src/repro/kernels/bsr_spmm/kernel.py:38) and _bitpack_kernel (:100):
// frontier_expand_packed, the per-owner-blocked candidate words of
// (A @ F) > 0.
//
// Inputs: K one-bit tiles `bits` (tile t, column c: four words over the
// tile's 128 rows, bit b of word q = row 32q + b), each tile's column mask
// `col_mask` (bit c of word w: column 32w + c holds an edge), each tile's
// block row (sorted) and block column, and the frontier packed
// along the vertex axis, `fwords` (n_block_cols * 4, S): bit c of word
// (bc * 4 + w, s) = column 128 bc + 32 w + c of source s.  The block rows
// fall into groups of `group_block_rows` (the engine's p shards, stacked
// block-diagonally); the first n_valid rows of a group split into
// n_blocks segments of `seg` rows, each packed into W = ceil(seg / 32)
// words (frontier.pack_bits).  Output: (groups * n_blocks * W, S), zeroed
// by the caller, who also hands int32 scratch for each frontier word's OR
// over the sources, and may hand a counter `tiles_read` (else null): the
// launch adds the tiles it listed, once whatever S (the CTAs of grid.y 0).
//
// Bound on the H100: memory.  A tile is 2 KiB at one bit an entry (64 KiB
// as the f32 tile), and the work per tile is a few ORs per edge; the
// output and the frontier are small beside the tiles.  So the design
// reads as few tile bytes as it can, and reads them in wide async copies:
//   * A small pass first: `front_any_kernel` ORs each frontier word over
//     the sources (the columns any source has in its frontier).
//   * Skip.  A CTA scans 256 tiles at a time, one a thread: a tile is
//     needed only if its column mask meets the sources' OR of its block
//     column's frontier words.  A tile no frontier column reaches costs
//     24 bytes (mask, column, row), not 2 KiB; all-zero pad tiles have an
//     empty mask and are never loaded.  The needed tiles are compacted in
//     order into a list in shared memory (ballot and popc).
//   * Streaming.  The list is worked off in groups of kGroup tiles
//     through a ring of two stages: a group's tiles (16-byte cp.async,
//     coalesced: a tile is 128 consecutive 16-byte pieces) and the
//     frontier words its sources read (4-byte cp.async) land on the
//     stage's mbarrier, while the CTA ORs the group before.
//   * Balance.  The scans are fixed slices of the sorted tile list, dealt
//     to a persistent grid in turn, so a long block row (an rmat hub) is
//     split over many CTAs and each CTA sees every part of the graph.
//     Each CTA ORs its part of a row into registers and merges it into the
//     output with atomicOr.  OR is idempotent, associative and commutative
//     and the output starts at zero, so every output word ends as the OR
//     of all its tiles' contributions whatever the order: bitwise the same
//     result on every run.
//   * Threads.  A CTA has 4 teams of 64 sources; S past 64 is tiled over
//     grid.y.  The teams take a group's tiles in turn.  A thread owns one
//     source's 128 rows of the team's current block row, as four words in
//     registers: for each of its tiles it walks the set bits of the
//     column mask (uniform across the team) and ORs the column's 16-byte
//     row words where its source's frontier bit is set.  The words stay
//     in registers until the team's block row changes, so a row is merged
//     into the output once per CTA and run of tiles, not once per tile.
//     The segmented layout is written directly at that merge: a 32-row
//     word may straddle a segment boundary when seg % 32 != 0, and is then
//     split into pieces, each shifted into place.
// Offsets into the tiles, the frontier and the output are int64 (K * 512
// words passes 2^32 on rmat_1m).
// ---------------------------------------------------------------------------
constexpr int kBM = 128;                    // tile rows == tile columns
constexpr int kXSrc = 64;                   // sources per team
constexpr int kTeams = 4;                   // teams a CTA
constexpr int kXThreads = kXSrc * kTeams;
constexpr int kScan = kXThreads;            // tiles tested at a time
constexpr int kXStages = 2;
// 8 tiles a stage fit four CTAs an SM (56 KB of shared memory, at most
// 64 registers a thread); larger stages at fewer CTAs were slower
constexpr int kGroup = 8;                   // tiles a stage holds
constexpr int kMinCtas = 4;                 // resident CTAs an SM

struct ExpandStage {
  uint4 tile[kGroup][kBM];                  // column c of tile j: 4 row words
  uint32_t front[kGroup][4][kXSrc];         // its sources' frontier words
  unsigned long long bar;                   // mbarrier of the stage's copies
};

struct ExpandShared {
  ExpandStage st[kXStages];
  uint4 cmask[kScan];                       // the scan's needed tiles, in
  int32_t tile[kScan];                      // order: column mask, index,
  int32_t col[kScan];                       // block column and block row
  int32_t row[kScan];
  int32_t warp_need[kXThreads / 32];
  // the tiles this CTA listed, kept by thread 0 in shared memory: the
  // kernel already sits at the 64 registers of its launch bound
  uint32_t listed;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// one arrival on `bar` once every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// front_any[r] = OR over the sources of frontier word row r (a warp a row)
__global__ void __launch_bounds__(kThreads)
front_any_kernel(const uint32_t* __restrict__ fwords, int64_t n_words,
                 int64_t s, uint32_t* __restrict__ front_any) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x / 32);
  for (int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       r < n_words; r += warps) {
    uint32_t v = 0;
    for (int64_t j = lane; j < s; j += 32) v |= fwords[r * s + j];
    v = __reduce_or_sync(0xffffffffu, v);
    if (lane == 0) front_any[r] = v;
  }
}

__global__ void __launch_bounds__(kXThreads, kMinCtas)
bsr_expand_bits_kernel(const uint4* __restrict__ bits,
                       const uint4* __restrict__ col_mask,
                       const int32_t* __restrict__ block_rows,
                       const int32_t* __restrict__ block_cols,
                       const uint32_t* __restrict__ fwords,
                       const uint4* __restrict__ front_any,
                       uint32_t* __restrict__ out,
                       unsigned long long* __restrict__ tiles_read, int64_t k,
                       int64_t group_block_rows, int64_t n_valid,
                       int64_t n_blocks, int64_t seg, int64_t w, int64_t s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ExpandShared& sh = *reinterpret_cast<ExpandShared*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sl = tid % kXSrc;               // source within the CTA
  const int team = tid / kXSrc;             // (in prepare: frontier word)
  const int64_t src = (int64_t)blockIdx.y * kXSrc + sl;
  const bool live = src < s;

  if (tid == 0) {
    for (int i = 0; i < kXStages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_u32(&sh.st[i].bar)), "r"(kXThreads)
                   : "memory");
    sh.listed = 0u;
  }
  __syncthreads();

  // Copies of list entries [i0, i0 + kGroup) into stage x: the tiles, and
  // the frontier word of each (source, mask word) the ORs will read; every
  // thread then arrives once on x's mbarrier, when its copies have landed.
  auto prepare = [&](int i0, int n_list, ExpandStage& x) {
    const int piece = tid % kBM, half = tid / kBM;
    for (int j = 0; j < kGroup && i0 + j < n_list; ++j) {
      const int i = i0 + j;
      if ((j & 1) == half)
        cp_async16(&x.tile[j][piece],
                   bits + (int64_t)sh.tile[i] * kBM + piece);
      const int q = team;                   // this thread's frontier word
      const uint32_t m = reinterpret_cast<const uint32_t*>(&sh.cmask[i])[q];
      if (m && live)
        cp_async4(&x.front[j][q][sl],
                  fwords + ((int64_t)sh.col[i] * 4 + q) * s + src);
    }
    cp_async_arrive(smem_u32(&x.bar));
  };

  // OR of one source's 32-row word `acc`, word q of block row `br`, into
  // the segmented output (pack_bits layout), in pieces that stay in one
  // segment.
  auto flush_word = [&](int64_t br, int q, uint32_t acc) {
    if (!acc) return;
    const int64_t g = br / group_block_rows;
    const int64_t rr0 = (br - g * group_block_rows) * kBM + q * 32;
    const int64_t base = g * n_blocks * w;
    int pos = 0;
    while (pos < 32 && (acc >> pos) != 0u) {
      const int64_t rr = rr0 + pos;
      if (rr >= n_valid) break;
      const int64_t b = rr / seg, i = rr - b * seg;
      const int len = seg - i < 32 - pos ? (int)(seg - i) : 32 - pos;
      const uint32_t piece =
          (acc >> pos) & (len == 32 ? 0xffffffffu : (1u << len) - 1u);
      if (piece) {
        const int64_t wi = base + b * w + (i >> 5);
        const int sh_ = (int)(i & 31);
        atomicOr(out + wi * s + src, piece << sh_);
        if (sh_ + len > 32)
          atomicOr(out + (wi + 1) * s + src, piece >> (32 - sh_));
      }
      pos += len;
    }
  };

  // the team's block row `cur` and this source's 128 rows of it
  int64_t cur = -1;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  auto flush = [&]() {
    if (cur < 0 || !live) return;
    flush_word(cur, 0, acc.x);
    flush_word(cur, 1, acc.y);
    flush_word(cur, 2, acc.z);
    flush_word(cur, 3, acc.w);
  };

  auto compute = [&](int i0, int n_list, const ExpandStage& x) {
    for (int j = team; j < kGroup && i0 + j < n_list; j += kTeams) {
      const int i = i0 + j;
      const int64_t br = sh.row[i];
      if (br != cur) {
        flush();
        acc = make_uint4(0u, 0u, 0u, 0u);
        cur = br;
      }
      const uint32_t* cm = reinterpret_cast<const uint32_t*>(&sh.cmask[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t m = cm[kk];
        if (!m) continue;                 // uniform across the team
        const uint32_t fw = live ? x.front[j][kk][sl] : 0u;
        while (m) {                       // uniform across the team
          const int c = __ffs(m) - 1;
          m &= m - 1;
          const uint4 v = x.tile[j][kk * 32 + c];
          if ((fw >> c) & 1u) {
            acc.x |= v.x;
            acc.y |= v.y;
            acc.z |= v.z;
            acc.w |= v.w;
          }
        }
      }
    }
  };

  const int64_t n_scans = (k + kScan - 1) / kScan;
  int stage = 0;
  unsigned phase = 0;                       // bit i: parity of stage i
  for (int64_t scan = blockIdx.x; scan < n_scans; scan += gridDim.x) {
    // test one tile a thread and list the needed ones in order
    const int64_t t = scan * kScan + tid;
    bool need = false;
    uint4 cm = make_uint4(0u, 0u, 0u, 0u);
    int32_t bc = 0, br = 0;
    if (t < k) {
      cm = __ldg(col_mask + t);
      bc = __ldg(block_cols + t);
      br = __ldg(block_rows + t);
      const uint4 f = __ldg(front_any + bc);
      need = ((cm.x & f.x) | (cm.y & f.y) | (cm.z & f.z) | (cm.w & f.w)) != 0u;
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, need);
    if (lane == 0) sh.warp_need[warp] = __popc(ballot);
    __syncthreads();
    int n_list = 0, before = 0;
#pragma unroll
    for (int i = 0; i < kXThreads / 32; ++i) {
      const int c = sh.warp_need[i];
      before += i < warp ? c : 0;
      n_list += c;
    }
    if (tid == 0) sh.listed += (uint32_t)n_list;
    if (need) {
      const int i = before + __popc(ballot & ((1u << lane) - 1u));
      sh.cmask[i] = cm;
      sh.tile[i] = (int32_t)t;
      sh.col[i] = bc;
      sh.row[i] = br;
    }
    __syncthreads();                        // the list is complete

    if (n_list) prepare(0, n_list, sh.st[stage]);
    for (int i0 = 0; i0 < n_list; i0 += kGroup) {
      if (i0 + kGroup < n_list) prepare(i0 + kGroup, n_list, sh.st[stage ^ 1]);
      mbar_wait(smem_u32(&sh.st[stage].bar), (phase >> stage) & 1u);
      phase ^= 1u << stage;
      compute(i0, n_list, sh.st[stage]);
      __syncthreads();                      // the stage is free again
      stage ^= 1;
    }
  }
  flush();
  if (tiles_read != nullptr && tid == 0 && blockIdx.y == 0 && sh.listed)
    atomicAdd(tiles_read, (unsigned long long)sh.listed);
}

// ---------------------------------------------------------------------------
// expand_dense: the default engine's top-down expansion of a 1-D dense level
// on the packed wire.  It replaces no Pallas kernel: the JAX expansion is
// XLA's gather of an (E, S) byte array and its scatter-max
// (src/repro/core/frontier.py expand_dense), followed by pack_bits.
//
// Inputs: the stacked shards' frontier, (rows, S) uint8 with rows = g *
// shard; the out-edge CSR by source, row_ptr (rows + 1) int64 and each
// edge's global target dst (E) int32 (kernels/expand_dense.py edge_csr).
// Output: each shard's candidates, (g, n) rows of S bits, as the words of
// pack_bits(cand, n_blocks): bit i of word (b * W + i / 32, s) is row
// b * m + i of column s, m = n / n_blocks, W = ceil(m / 32); pad bits zero.
//
// Bound on the H100: memory.  A level reads each source's S frontier bytes
// once and, for the sources in some column's frontier, their int32 targets;
// it ORs a 64-bit mask into an (g * n, ceil(S / 64)) table per such edge
// and writes the table out as words.  At scale 20 (S = 64) that is about
// 0.3 GB where the gather and scatter-max move several.  Design, four steps
// on the caller's stream:
//   * the table is zeroed (cudaMemsetAsync);
//   * dense_mask_kernel folds each source row's S bytes into ceil(S / 64)
//     64-bit masks, one thread a (row, mask), 16-byte loads where S allows;
//   * chunk_rows_kernel finds the first source of each fixed chunk of
//     `chunk` edges (a binary search of row_ptr a chunk);
//   * expand_dense_kernel pushes.  A persistent grid of warps walks the
//     chunks in turn, so an rmat hub's thousands of edges are split over
//     many warps and no warp owns a whole adjacency.  From its chunk's
//     first source a warp holds the ends and masks of 32 consecutive
//     sources, one a lane: it skips every run of sources
//     whose masks are zero, with their edges, and works the rest 32 edges
//     at a time, each lane finding its edge's source among the 32 by a
//     binary search over the lanes (shuffles).  A lane reads its target and
//     ORs each nonzero mask word into the target's table row with
//     atomicOr.  OR is exact, idempotent and order-free and the table
//     starts at zero, so the result is bitwise the scatter-max's (a max of
//     0/1 is an OR) on every run;
//   * dense_pack_kernel writes the table out as the wire's words: a warp
//     reads 32 consecutive rows' 64-bit words (one coalesced load) and
//     transposes them as two 32 x 32 bit matrices (five shuffle steps
//     each), so lane c holds column c's word, stored coalesced.
// edges_read, where not null, gains the edges pushed (sources with some
// nonzero mask word): one atomicAdd a CTA.
// ---------------------------------------------------------------------------
// 8 bytes -> 8 bits, bit i set iff byte i is nonzero
__device__ __forceinline__ uint32_t nonzero_bytes(uint64_t x) {
  const uint64_t lo7 = 0x7f7f7f7f7f7f7f7fULL;
  const uint64_t t = (((x & lo7) + lo7) | x) & 0x8080808080808080ULL;
  return (uint32_t)(((t >> 7) * 0x0102040810204080ULL) >> 56);
}

__global__ void __launch_bounds__(kThreads)
dense_mask_kernel(const uint8_t* __restrict__ frontier,
                  uint64_t* __restrict__ fmask, int64_t rows, int64_t s,
                  int64_t k64, int vec) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * k64) return;
  const int64_t r = t / k64;
  const int64_t c0 = (t - r * k64) * 64;
  const int64_t len = s - c0 < 64 ? s - c0 : 64;
  const uint8_t* p = frontier + r * s + c0;
  uint64_t m = 0;
  if (vec) {                                // S % 16 == 0, 16-byte aligned
    for (int q = 0; q < len / 16; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[q];
      const uint64_t a = ((uint64_t)v.y << 32) | v.x;
      const uint64_t b = ((uint64_t)v.w << 32) | v.z;
      m |= (uint64_t)(nonzero_bytes(a) | nonzero_bytes(b) << 8) << (16 * q);
    }
  } else {
    for (int i = 0; i < len; ++i) m |= (uint64_t)(p[i] != 0) << i;
  }
  fmask[t] = m;
}

// chunk_rows[c]: the source row v with row_ptr[v] <= c * chunk < row_ptr[v + 1]
__global__ void __launch_bounds__(kThreads)
chunk_rows_kernel(const int64_t* __restrict__ row_ptr,
                  int64_t* __restrict__ chunk_rows, int64_t rows,
                  int64_t n_chunks, int64_t chunk) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chunks) return;
  const int64_t e = c * chunk;
  int64_t lo = 0, hi = rows;                // row_ptr[lo] <= e < row_ptr[hi]
  while (hi - lo > 1) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (row_ptr[mid] <= e) lo = mid;
    else hi = mid;
  }
  chunk_rows[c] = lo;
}

__global__ void __launch_bounds__(kThreads)
expand_dense_kernel(const int64_t* __restrict__ row_ptr,
                    const int32_t* __restrict__ dst,
                    const uint64_t* __restrict__ fmask,
                    unsigned long long* __restrict__ table,
                    const int64_t* __restrict__ chunk_rows,
                    unsigned long long* __restrict__ edges_read, int64_t rows,
                    int64_t shard, int64_t n, int64_t k64, int64_t n_edges,
                    int64_t chunk) {
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ unsigned long long cta_edges;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) cta_edges = 0;
  __syncthreads();
  unsigned long long pushed = 0;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x / 32);
  const int64_t n_chunks = (n_edges + chunk - 1) / chunk;
  for (int64_t c = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       c < n_chunks; c += warps) {
    int64_t e = c * chunk;
    const int64_t c1 = e + chunk < n_edges ? e + chunk : n_edges;
    int64_t v = chunk_rows[c];              // row_ptr[v] <= e < row_ptr[v + 1]
    while (e < c1) {
      // lane j: source row v + j, its end and its masks' first word
      const int64_t r = v + lane;
      int64_t end = INT64_MAX;
      uint64_t m0 = 0;
      bool act = false;
      if (r < rows) {
        end = row_ptr[r + 1];
        const uint64_t* fm = fmask + r * k64;
        m0 = fm[0];
        act = m0 != 0;
        for (int64_t w = 1; w < k64 && !act; ++w) act = fm[w] != 0;
      }
      const int64_t last = __shfl_sync(kAll, end, 31);
      const unsigned live = __ballot_sync(kAll, act && end > e);
      if (!live) {                          // no source here is in a frontier
        if (last >= c1) break;
        e = last;
        v += 32;
        continue;
      }
      const int first = __ffs(live) - 1;
      if (first > 0) {                      // skip to the first live source
        const int64_t start = __shfl_sync(kAll, end, first - 1);
        if (start >= c1) break;
        e = start > e ? start : e;
        v += first;
        continue;
      }
      // edges [e, lim) all leave sources v .. v + 31
      int64_t lim = e + 32 < c1 ? e + 32 : c1;
      lim = lim < last ? lim : last;
      const int64_t ei = e + lane;
      int k = 0;                            // lanes whose source ends <= ei
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(kAll, end, k + step - 1) <= ei) k += step;
      const uint64_t mask = __shfl_sync(kAll, m0, k);
      const bool on = __shfl_sync(kAll, (int)act, k);
      if (ei < lim && on) {
        const int64_t src = v + k;
        unsigned long long* row =
            table + ((src / shard) * n + dst[ei]) * k64;
        // a read first: bits are only ever set, so a row that already
        // holds the mask needs no atomic (the widest levels repeat most)
        if (mask && (__ldcg(row) & mask) != mask)
          atomicOr(row, (unsigned long long)mask);
        for (int64_t w = 1; w < k64; ++w) {
          const uint64_t mw = fmask[src * k64 + w];
          if (mw && (__ldcg(row + w) & mw) != mw)
            atomicOr(row + w, (unsigned long long)mw);
        }
        ++pushed;
      }
      v += __popc(__ballot_sync(kAll, end <= lim));
      e = lim;
    }
  }
  if (edges_read != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      pushed += __shfl_down_sync(kAll, pushed, off);
    if (lane == 0 && pushed) atomicAdd(&cta_edges, pushed);
    __syncthreads();
    if (threadIdx.x == 0 && cta_edges) atomicAdd(edges_read, cta_edges);
  }
}

// transpose the 32 x 32 bit matrix a warp holds, a row a lane (bit c of
// lane r's word = entry (r, c)): lane c gets column c (bit r = entry (r, c))
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  constexpr uint32_t kLow[5] = {0x55555555u, 0x33333333u, 0x0f0f0f0fu,
                                0x00ff00ffu, 0x0000ffffu};
#pragma unroll
  for (int i = 4; i >= 0; --i) {
    const int j = 1 << i;
    const uint32_t m = kLow[i];             // the columns c with c & j == 0
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) ? (x & ~m) | ((y & ~m) >> j) : (x & m) | ((y & m) << j);
  }
  return x;
}

// a warp an output word row (32 table rows): each 64-bit table word is
// two 32 x 32 bit matrices, transposed so that lane c holds column c's word
__global__ void __launch_bounds__(kThreads)
dense_pack_kernel(const uint64_t* __restrict__ table,
                  uint32_t* __restrict__ out, int64_t g, int64_t n,
                  int64_t n_blocks, int64_t w, int64_t s, int64_t k64) {
  const int lane = threadIdx.x & 31;
  const int64_t item = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (item >= g * n_blocks * w) return;     // whole warps
  const int64_t wi = item % w;              // item = (shard * n_blocks + b)
  const int64_t gb = item / w;              //        * w + wi
  const int64_t m = n / n_blocks;
  const int64_t row0 = (gb / n_blocks) * n + (gb % n_blocks) * m + wi * 32;
  const bool in = wi * 32 + lane < m;       // a block's pad rows read 0
  uint32_t* o = out + item * s;
  for (int64_t kw = 0; kw < k64; ++kw) {
    const uint64_t v = in ? table[(row0 + lane) * k64 + kw] : 0;
    const uint32_t lo = transpose32((uint32_t)v, lane);
    const uint32_t hi = transpose32((uint32_t)(v >> 32), lane);
    const int64_t c = kw * 64 + lane;
    if (c < s) o[c] = lo;
    if (c + 32 < s) o[c + 32] = hi;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

unsigned int grid_for(int64_t n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int bfs_fold_update(const void* words, const void* dist, void* dist_out,
                    void* new_out, void* words_out, long long batch,
                    long long w, long long m, long long s, int level,
                    void* stream) {
  fold_update_kernel<<<grid_for(batch * w * s), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int32_t*)dist, (int32_t*)dist_out,
      (uint8_t*)new_out, (uint32_t*)words_out, batch, w, m, s, level);
  return (int)cudaGetLastError();
}

// Y = A @ X over f32 tiles (A2).  `work` lists the n_items = block rows x
// n_dt (block row, 64-column) items, br * n_dt + j, largest row first.
int bfs_bsr_spmm(const void* blocks, const void* row_ptr,
                 const void* block_cols, const void* work, const void* x,
                 void* y, const void* least, long long k, long long n_items,
                 long long n_dt, long long d, void* stream) {
  CUtensorMap tm;
  memset(&tm, 0, sizeof(tm));   // no tile: the map is never read
  if (k > 0) {
    // the (K * 128, 128) tiles, box 32 columns x 128 rows
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)spmm::kB,
                                (cuuint64_t)k * spmm::kB};
    const cuuint64_t strides[1] = {(cuuint64_t)spmm::kB * 4};
    const cuuint32_t box[2] = {(cuuint32_t)spmm::kPanel,
                               (cuuint32_t)spmm::kB};
    const cuuint32_t elem[2] = {1, 1};
    if (encode(&tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
               const_cast<void*>(blocks), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  for (auto kernel : {spmm::bsr_spmm_kernel<false>,
                      spmm::bsr_spmm_kernel<true>}) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, spmm::kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long ctas = (n_items + spmm::kConsumers - 1) / spmm::kConsumers;
  if (ctas > sms) ctas = sms;
  const int vec = d % 2 == 0 && (uintptr_t)x % 8 == 0 && (uintptr_t)y % 8 == 0;
  for (auto kernel : {spmm::bsr_spmm_kernel<false>,
                      spmm::bsr_spmm_kernel<true>}) {
    kernel<<<(unsigned int)ctas, spmm::kThreads, spmm::kSmem,
             (cudaStream_t)stream>>>(
        tm, (const int32_t*)row_ptr, (const int32_t*)block_cols,
        (const int32_t*)work, (const float*)x, (float*)y, n_items, n_dt, d,
        vec, n_dt == 1, (const int32_t*)least);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int bfs_bitpack(const void* mask, void* out, long long w, long long s,
                void* stream) {
  bitpack_kernel<<<grid_for(w * s), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)mask, (uint32_t*)out, w, s);
  return (int)cudaGetLastError();
}

// dynamic shared memory of one bsr_expand_bits CTA
int bfs_expand_bits_smem() { return (int)sizeof(ExpandShared); }

// The frontier's OR over the sources, then the expansion; front_any
// (n_fwords int32) is scratch, tiles_read a counter or null.  The caller
// launches only with k > 0 tiles.
int bfs_bsr_expand_bits(const void* bits, const void* col_mask,
                        const void* block_rows, const void* block_cols,
                        const void* fwords, void* out, void* front_any,
                        void* tiles_read, long long k, long long n_fwords,
                        long long group_block_rows, long long n_valid,
                        long long n_blocks, long long seg, long long w,
                        long long s, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = bfs_expand_bits_smem();
  cudaError_t err = cudaFuncSetAttribute(
      bsr_expand_bits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  front_any_kernel<<<grid_for(n_fwords * 32), kThreads, 0, st>>>(
      (const uint32_t*)fwords, n_fwords, s, (uint32_t*)front_any);
  const long long n_scans = (k + kScan - 1) / kScan;
  const long long src_tiles = (s + kXSrc - 1) / kXSrc;
  long long ctas = (long long)kMinCtas * sms / src_tiles;
  if (ctas < 1) ctas = 1;
  if (ctas > n_scans) ctas = n_scans;
  const dim3 grid((unsigned int)ctas, (unsigned int)src_tiles);
  bsr_expand_bits_kernel<<<grid, kXThreads, smem, st>>>(
      (const uint4*)bits, (const uint4*)col_mask,
      (const int32_t*)block_rows, (const int32_t*)block_cols,
      (const uint32_t*)fwords, (const uint4*)front_any, (uint32_t*)out,
      (unsigned long long*)tiles_read, k, group_block_rows, n_valid, n_blocks,
      seg, w, s);
  return (int)cudaGetLastError();
}

// The dense level's expansion to packed words (expand_dense): zero the
// table, fold the frontier into masks, find the chunks' first sources,
// push, pack.  fmask ((g * shard) * ceil(s / 64) words), table ((g * n) *
// ceil(s / 64) words) and chunk_rows (ceil(n_edges / chunk) words) are
// scratch, edges_read a counter or null.
int bfs_expand_dense(const void* frontier, const void* row_ptr,
                     const void* dst, void* fmask, void* table,
                     void* chunk_rows, void* out, void* edges_read,
                     long long g, long long shard, long long n,
                     long long n_blocks, long long n_edges, long long chunk,
                     long long s, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long rows = g * shard, k64 = (s + 63) / 64;
  const long long w = (n / n_blocks + 31) / 32;
  cudaError_t err = cudaMemsetAsync(table, 0, (size_t)(g * n * k64) * 8, st);
  if (err != cudaSuccess) return (int)err;
  const int vec = s % 16 == 0 && (uintptr_t)frontier % 16 == 0;
  if (rows > 0) {
    dense_mask_kernel<<<grid_for(rows * k64), kThreads, 0, st>>>(
        (const uint8_t*)frontier, (uint64_t*)fmask, rows, s, k64, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (n_edges > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long n_chunks = (n_edges + chunk - 1) / chunk;
    chunk_rows_kernel<<<grid_for(n_chunks), kThreads, 0, st>>>(
        (const int64_t*)row_ptr, (int64_t*)chunk_rows, rows, n_chunks, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    long long ctas = (long long)sms * (2048 / kThreads);
    const long long enough = (n_chunks + kThreads / 32 - 1) / (kThreads / 32);
    if (ctas > enough) ctas = enough;
    expand_dense_kernel<<<(unsigned int)ctas, kThreads, 0, st>>>(
        (const int64_t*)row_ptr, (const int32_t*)dst, (const uint64_t*)fmask,
        (unsigned long long*)table, (const int64_t*)chunk_rows,
        (unsigned long long*)edges_read, rows, shard, n, k64, n_edges, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  dense_pack_kernel<<<grid_for(g * n_blocks * w * 32), kThreads, 0, st>>>(
      (const uint64_t*)table, (uint32_t*)out, g, n, n_blocks, w, s, k64);
  return (int)cudaGetLastError();
}

const char* bfs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
