// Hand-written Hopper (sm_90a) attention kernels of the LM prefill path.
//
// Built with the other kernels by repro_torch/kernels/_build.py (nvcc
// -gencode arch=compute_90a,code=sm_90a, one object per source, linked into
// one shared library with a plain C interface, loaded with ctypes).  Each
// entry point launches on the caller's stream, allocates nothing and returns
// a cudaError_t so the Python wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// A4 flash attention forward: replaces the Pallas kernel _flash_kernel
// (src/repro/kernels/flash_attention/kernel.py:31, launched by
// flash_attention).
//
// q (B, Hq, Sq, Dh), k and v (B, Hkv, Skv, Dh), contiguous, Dh in
// {32, 64, 128, 256}; o (B, Hq, Sq, Dh) in q's dtype.  q head h reads kv
// head h / (Hq / Hkv) of the same batch row (kernel.py:106-107).  The mask
// keeps a key when q_pos >= k_pos (causal) and q_pos - k_pos < window
// (window > 0), positions counted from 0 in q and in k alike.  The softmax
// is online with f32 running max m, sum l and accumulator; masked scores
// never count, p is zeroed while m is still NEG_INF and alpha while the
// previous m is (kernel.py:63-66), and a row that sees no key is written as
// zeros (l == 0, kernel.py:78).  l sums the f32 p; in bf16, p is rounded to
// bf16 before the PV product (kernel.py:69-71), as on the TPU.
//
// What the TPU schedule does not carry over: the Pallas grid walks every kv
// block of every q block in order and asserts Sq, Skv % block == 0.  Here a
// CTA owns one (batch x q head, q tile) and loops over only the kv tiles
// that the causal and window masks leave visible (for a 1024-token window
// about 18 of Skv / 64); rows and keys past Sq and Skv are masked or
// bounds-checked, so any Sq, Skv >= 1 is taken.  Skipping a tile that is
// masked for every row is exact: such a tile leaves (m, l, acc) unchanged
// in the TPU kernel too.  q tiles run from the last (the longest causal
// row) to the first, and the q heads of one kv group are adjacent in the
// grid, so their K and V tiles can be read from L2.
//
// Bound on the H100: operations.  The work is 4 * Dh FLOP per visible
// (q, k) pair against 2 * Dh * (Sq + 2 Skv) input bytes per head: at
// Dh = 256 and a causal 8192-token prompt about 2000 FLOP per byte (1000
// in f32), far above the ridge of the bf16 tensor cores (295) and of
// three TF32 products (148 FLOP per byte at 495 TFLOP/s / 3).  Two routes,
// chosen by dtype in the wrapper (kernels/flash_attention/kernel.py):
//
// bf16, flash_fwd_wgmma: the tensor cores, fed by TMA, warp-specialised.
//   A CTA of 384 threads owns 128 q rows: warpgroups 0 and 1 consume (64
//   rows each), warpgroup 2 produces (one thread issues every load) and
//   gives its registers away (setmaxnreg 24 against 240).  The Q tile is
//   loaded once; K and V tiles of 64 keys sit in a ring of two stages, each
//   with a full and an empty mbarrier.  TMA reads through 3-D tensor maps
//   (Dh, S, B*H), so a tile past Sq or Skv is zero-filled inside its own
//   head, in 128-byte-swizzled panels of 64 columns (Dh = 32: one 64-byte
//   panel).  S = Q K^T is wgmma m64n64k16 with both operands in shared
//   memory, K-major; the online softmax runs on the f32 accumulator
//   fragment (quad shuffles, exp2 with scale * log2(e) folded in; the mask
//   only on tiles that cross the diagonal, the window edge or Skv); P is
//   converted to bf16 in registers, where it is already the A fragment of
//   O += P V, wgmma m64n{Dh}k16 with V as the MN-major (transposed) shared
//   memory operand.  The f32 O accumulator (Dh / 2 registers a thread)
//   stays in registers; the epilogue divides by l (1 where l == 0), rounds
//   to bf16 and stores the rows below Sq.  Shared memory at Dh = 256: Q 64
//   KB + 2 x (32 + 32) KB = 192 KB.  ptxas gives the consumer warpgroups
//   their 240 registers only while their path has no trap and no call; with
//   a trap in it the Dh = 256 kernel was held to the launch's 168 and
//   spilled the O accumulator.
//
// f32, flash_fwd_tf32: split TF32 ("3xTF32") on wgmma, fed by TMA.  The
//   tensor cores take f32 only as TF32 (10 mantissa bits), one pass of
//   which misses the f32 hold (2e-5).  Every operand is split as A2's in
//   bfs_kernels.cu: hi is the f32 word as the tensor core reads it (its 13
//   low bits dropped), lo = v - hi rounded to TF32, and each product is
//   lo hi + hi lo + hi hi, the small ones first.  Three TF32 products bound
//   it: 6.66 ms at gemma3-12b's global layer (q (2, 16, 8192, 256), causal)
//   against 16.41 ms for f32 FMA on the CUDA cores.  What the design does
//   about the four things TF32 attention raises:
//   - TF32 wgmma takes both operands K-major.  S = Q K^T is, as Q and K lie;
//     O += P V is not, V being (key, Dh).  A pre-pass (split_kv_kernel, one
//     launch before the attention kernel) writes V^T (B * Hkv, Dh, keys
//     padded to 32) and its lo, and K's hi and lo; q is split in the
//     kernel, once a CTA, into shared memory (fence.proxy.async before
//     wgmma reads it).
//   - The accumulator gives a thread keys 2c, 2c + 1 of each 8-key step,
//     the register A operand wants columns c, c + 4 (c = lane % 4).  The
//     pre-pass stores each group of 8 keys of V^T as 0 2 4 6 1 3 5 7, so
//     the S fragment, split into hi and lo registers, is the A operand of
//     the PV k8 steps with no shuffle.
//   - Shared memory: at Dh = 256, Q and its lo for 64 rows take 128 KB, so
//     a CTA owns 64 q rows.  Its two consumer warpgroups share them and take
//     alternate kv tiles of 64 keys, each with its own online softmax and O
//     (Dh / 2 registers a thread), and its own ring of 3 slots of 16 KB fed
//     by one producer thread: a slot is a 32-column panel of K, or of V^T
//     (64 Dh rows x 32 keys; 32 rows at Dh 32 and 256, see Cfg), hi and
//     lo, 128-byte swizzled.  One warpgroup's softmax runs beside the
//     other's products.  At the end consumer 1 hands its (m, l, O) through
//     shared memory and consumer 0 merges and stores.  At Dh = 256: 128 +
//     96 KB.
//   - The tensor core truncates each k8 step into its accumulator, about
//     2^-23 of the accumulator a step; an O row sums thousands of steps.
//     So each slot's 12 products (three of four k8 steps: wgmma m64n64k8
//     for S, m64n64k8 or m64n32k8 for PV) start from zero and join S, or
//     their chunk of O, in IEEE f32 adds; O's rescale by alpha stays an
//     IEEE multiply.
//   On the H100 it takes 12.76 ms at that global layer, 52% of the bound
//   (PERF.md); pairing the two q heads of a kv group in a cluster of 2
//   that shared each K and V^T load by TMA multicast ran 2.25 times slower
//   and was taken out.
//   q, k, v and P are split by tf32.cuh's rule (kernels/tf32.py's), as
//   A2's operands are.  A non-finite q, k or v has hi 0 and goes to lo
//   whole, so each of its products meets the other side's hi alone and
//   reads +-inf or NaN as the plain version's does (K's hi is therefore the
//   pre-pass's, not K: raw K as hi made q_lo * inf = 0 * inf = NaN where q
//   is exact in TF32); a nonzero value below 2^-136 has hi copysign(2^-136),
//   so against an infinite value it reads +-inf too (2^-140 against +-inf
//   on the H100, tests/test_torch_cuda.py).  Only inf times inf reads NaN
//   where the plain version has +-inf, as in A2.
//   The row max propagates NaN (max.NaN), so a NaN key makes exactly the
//   rows that see it NaN, as the plain version's amax does.  The visible-
//   tile loop, its order and the masks are the bf16 kernel's.
// ---------------------------------------------------------------------------

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // kernel.py NEG_INF

// ========================================= bf16, wgmma + TMA, warp-specialised

namespace wg {

constexpr int kBQ = 128;          // q rows per CTA: two consumer warpgroups
constexpr int kBK = 64;           // keys per kv tile
constexpr int kStages = 2;        // K and V ring depth
constexpr int kThreads = 384;     // warpgroups 0, 1 consume; 2 produces
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 24 + 2 * 240 = 3 * 168 (launch bound)
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: [Q: NP panels of 128 rows][K: stages][V: stages][barriers],
// a panel being PW bf16 columns of SW bytes a row, swizzled by TMA as wgmma
// reads it.  Every region starts on a 1024-byte boundary (the swizzle atom).
template <int DH>
struct Cfg {
  static constexpr int SW = DH >= 64 ? 128 : 64;  // swizzle span: one row
  static constexpr int PW = SW / 2;               // panel width, columns
  static constexpr int NP = DH / PW;              // panels
  static constexpr int Q_PANEL = kBQ * SW;
  static constexpr int KV_PANEL = kBK * SW;
  static constexpr int Q_BYTES = kBQ * DH * 2;
  static constexpr int KV_BYTES = kBK * DH * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 4 * kStages);
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;  // B128 : B64
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout in bits 62-63
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from touching an accumulator across wgmma's async
// window: every read after the wait depends on this empty asm.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

#define F8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S (+)= A B^T, m64n64k16: A (64 x 16) and B (64 x 16) both K-major in
// shared memory; d is the 64 x 64 f32 fragment (32 a thread).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(d, 0), F8(d, 8),
        F8(d, 16), F8(d, 24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// O += P V, m64n{N}k16: P (64 x 16) the bf16 A fragment in registers (4 a
// thread), V (16 x N) MN-major in shared memory (imm-trans-b 1); d is the
// 64 x N f32 fragment (N / 2 a thread).
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8),
        F8(d, 16), F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8),
        F8(d, 16), F8(d, 24),
        F8(d, 32), F8(d, 40),
        F8(d, 48), F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8),
        F8(d, 16), F8(d, 24),
        F8(d, 32), F8(d, 40),
        F8(d, 48), F8(d, 56),
        F8(d, 64), F8(d, 72),
        F8(d, 80), F8(d, 88),
        F8(d, 96), F8(d, 104),
        F8(d, 112), F8(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef F8

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int hq, int group, int sq,
                int skv, int causal, int window, float scale_log2) {
  using C = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + C::K_OFF;
  const uint32_t v_s = base + C::V_OFF;
  const uint32_t bar = base + C::BAR_OFF;
  const uint32_t q_full = bar;
  // full_k[s], full_v[s], empty_k[s], empty_v[s]
  auto full_k = [&](int s) { return bar + 8 * (1 + s); };
  auto full_v = [&](int s) { return bar + 8 * (1 + kStages + s); };
  auto empty_k = [&](int s) { return bar + 8 * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bar + 8 * (1 + 3 * kStages + s); };

  const int bh = blockIdx.x;  // b * hq + h; kv head b * hkv + h / group
  const int kvh = (bh / hq) * (hq / group) + (bh % hq) / group;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kBQ;
  // the kv tiles any row of this CTA can see
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 8);  // one arrival per consumer warp
      mbar_init(empty_v(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int p = 0; p < C::NP; ++p)
        tma_load(q_s + p * C::Q_PANEL, &tm_q, q_full, p * C::PW, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t ph = (t / kStages) & 1;
        const int k0 = k_begin + t * kBK;
        mbar_wait(empty_k(s), ph ^ 1);
        mbar_expect_tx(full_k(s), C::KV_BYTES);
        for (int p = 0; p < C::NP; ++p)
          tma_load(k_s + s * C::KV_BYTES + p * C::KV_PANEL, &tm_k, full_k(s),
                   p * C::PW, k0, kvh);
        mbar_wait(empty_v(s), ph ^ 1);
        mbar_expect_tx(full_v(s), C::KV_BYTES);
        for (int p = 0; p < C::NP; ++p)
          tma_load(v_s + s * C::KV_BYTES + p * C::KV_PANEL, &tm_v, full_v(s),
                   p * C::PW, k0, kvh);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r0 = 16 * (tid / 32) + lane / 4;  // fragment rows r0, r0 + 8
    const int c2 = 2 * (lane % 4);               // fragment columns 8 j + c2
    const int row_lo = q0 + 64 * wgi;            // this warpgroup's rows
    const int row[2] = {row_lo + r0, row_lo + r0 + 8};

    // descriptors: Q and K K-major (rows SW bytes apart, 8-row groups
    // 8 SW apart); V MN-major (keys SW bytes apart, 64-column panels
    // KV_PANEL apart).  A k16 step is 32 bytes along a K-major row and
    // 16 keys (16 SW bytes) down V.
    constexpr int KSTEPS_PANEL = C::PW / 16;
    const uint64_t q_desc =
        smem_desc(q_s + 64 * wgi * C::SW, 16, 8 * C::SW, C::LAYOUT);
    const uint64_t k_desc = smem_desc(k_s, 16, 8 * C::SW, C::LAYOUT);
    const uint64_t v_desc =
        smem_desc(v_s, C::KV_PANEL, 8 * C::SW, C::LAYOUT);

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sum

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t ph = (t / kStages) & 1;
      const int k0 = k_begin + t * kBK;

      // S = Q K^T
      float sc[32];
      mbar_wait(full_k(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int panel = kk / KSTEPS_PANEL;
        const int in_panel = (kk % KSTEPS_PANEL) * 32;
        wgmma_ss(sc, q_desc + ((panel * C::Q_PANEL + in_panel) >> 4),
                 k_desc + ((s * C::KV_BYTES + panel * C::KV_PANEL +
                            in_panel) >> 4),
                 kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(empty_k(s));

      // mask: only tiles that cross Skv, the diagonal or the window edge
      const bool edge = k0 + kBK > skv ||
                        (causal && k0 + kBK - 1 > row_lo) ||
                        (window > 0 && row_lo + 63 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = k0 + 8 * j + c2 + e;
              bool keep = kpos < skv;
              if (causal) keep = keep && row[i] >= kpos;
              if (window > 0) keep = keep && row[i] - kpos < window;
              if (!keep) sc[4 * j + 2 * i + e] = -INFINITY;
            }
      }

      // online softmax on the fragment: row i of this thread holds
      // sc[4 j + 2 i + e]; the 4 lanes of a quad share the row
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[i], mx * scale_log2);
        const bool live = m_new > kNegInf / 2;
        alpha[i] = m_run[i] > kNegInf / 2 ? ex2(m_run[i] - m_new) : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * i + e];
            x = live ? ex2(fmaf(x, scale_log2, -m_new)) : 0.f;
            sum += x;
          }
        l_run[i] = alpha[i] * l_run[i] + sum;
        m_run[i] = m_new;
      }

      // P in bf16 is the A fragment of the PV product, k16 step kk taking
      // key columns 16 kk .. 16 kk + 15
      uint32_t pa[16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[4 * kk + r] =
              pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }

      // O += P V
      mbar_wait(full_v(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, pa + 4 * kk,
                 v_desc + ((s * C::KV_BYTES + kk * 16 * C::SW) >> 4));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty_v(s));
    }

    // epilogue: O / l in bf16, rows below Sq
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l == 0.f ? 1.f : 1.f / l;
      if (row[i] >= sq) continue;
      __nv_bfloat16* out = o + ((int64_t)bh * sq + row[i]) * DH + c2;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv,
                                  acc[4 * j + 2 * i + 1] * inv);
    }
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

// 3-D map (Dh, S, B * H) of a contiguous (B, H, S, Dh) bf16 tensor, box
// (PW, rows, 1): a box past S is zero-filled inside its own head
template <int DH>
bool head_map(CUtensorMap* map, const void* ptr, long long s, long long bh,
              int rows) {
  using C = Cfg<DH>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)DH, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)DH * 2, (cuuint64_t)s * DH * 2};
  const cuuint32_t box[3] = {(cuuint32_t)C::PW, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                long long b, long long hq, long long hkv, long long sq,
                long long skv, int causal, long long window, float scale,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!head_map<DH>(&tq, q, sq, b * hq, kBQ) ||
      !head_map<DH>(&tk, k, skv, b * hkv, kBK) ||
      !head_map<DH>(&tv, v, skv, b * hkv, kBK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma<DH>;
  constexpr int smem = Cfg<DH>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)(b * hq), (unsigned int)((sq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, (int)hq, (int)(hq / hkv), (int)sq,
      (int)skv, causal, (int)window, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ================================== f32: split TF32 on wgmma, fed by TMA

namespace tf {

using wg::fence_regs;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::smem_u32;
using wg::tma_load;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_wait_all;

constexpr int kBQ = 64;             // q rows a CTA, shared by both consumers
constexpr int kBK = 64;             // keys a kv tile
constexpr int kStages = 3;          // slots in each consumer's ring
constexpr int kThreads = 384;       // warpgroups 0, 1 consume; 2 produces
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 24 + 2 * 240 = 3 * 168 (launch bound)
constexpr int kSlot = 16384;        // a ring slot: the hi panel, lo at +kLo
constexpr int kLo = 8192;
constexpr int kPanel = 64 * 128;    // 64 rows of 32 f32, 128-byte swizzle
constexpr int kKeyPad = 32;         // V^T's rows are padded to this many keys
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: [Q: NP panels][Q lo: NP panels][ring 0][ring 1][barriers].
// A kv tile takes a consumer's ring slots in this order: NP panels of K
// (32 of its Dh columns, hi and lo); then for keys 0-31 of the tile, and
// again for keys 32-63, one panel of V^T (NV rows of Dh, hi and lo) for
// each chunk of NV of O's columns.  At Dh = 256 the chunks are 32 wide:
// O (128 registers), the split P (32), the second half's scores (16) and
// a 64-wide chunk's partial (32) left the compiler too few of the 240 and
// it spilled; 32-wide partials (16) do not.
template <int DH>
struct Cfg {
  static constexpr int NP = DH / 32;
  static constexpr int NV = DH == 64 || DH == 128 ? 64 : 32;
  static constexpr int Q_BYTES = kBQ * DH * 4;
  static constexpr int QLO_OFF = Q_BYTES;
  static constexpr int RING_OFF = 2 * Q_BYTES;
  static constexpr int BAR_OFF = RING_OFF + 2 * kStages * kSlot;
  // q_full, then full[w][s] and empty[w][s] of each consumer w
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 4 * kStages);
  static constexpr uint32_t K_TX = 2 * kBK * 128;
};

// the NaN-propagating maximum: a score that is NaN makes its row NaN, as
// the plain version's amax does (fmaxf would drop it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a row's running max counts as live unless it is NEG_INF (NaN is live)
__device__ __forceinline__ bool live(float m) { return !(m <= kNegInf / 2); }

// The wgmma descriptor of a K-major panel of 128-byte rows, 8-row groups
// 1024 bytes apart, 128-byte swizzle (wg::smem_desc(addr, 16, 1024, 1)),
// is a low word that carries the address and a constant high word.  The
// products take the low word alone and make the descriptor inside their
// asm, so the compiler holds one register a descriptor, not two.  A k8
// step is 32 bytes along the row.
__device__ __forceinline__ uint32_t desc(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | (1u << 16);
}
#define DESC_HI "0x40000040"  // stride 1024 bytes; 128-byte swizzle

#define F8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S (+)= A B^T, m64n64k8 TF32: A (64 x 8) and B (64 x 8) K-major in
// shared memory; accumulate = 0 writes A B^T over d
__device__ __forceinline__ void mma_ss(float (&d)[32], uint32_t a, uint32_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 h;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %34, 0;\nmov.b32 h, " DESC_HI ";\n"
      "mov.b64 da, {%32, h};\nmov.b64 db, {%33, h};\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "r"(a), "r"(b), "r"(accumulate));
}

// O-chunk (+)= P V, m64n{N}k8 TF32: P (64 x 8) four registers a thread, V^T
// (N x 8) K-major in shared memory
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint32_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 h;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %37, 0;\nmov.b32 h, " DESC_HI ";\n"
      "mov.b64 db, {%36, h};\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b),
        "r"(accumulate));
}

__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t* a,
                                       uint32_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 h;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %21, 0;\nmov.b32 h, " DESC_HI ";\n"
      "mov.b64 db, {%20, h};\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, db, p, 1, 1;\n}\n"
      : F8(d, 0), F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b),
        "r"(accumulate));
}

#undef F8
#undef DESC_HI

// The pre-pass: for each (kv head, 32 keys, 32 Dh columns) K's hi and lo,
// and V transposed to (Dh, keys) as hi and lo, the keys of each group of 8
// stored in the order 0 2 4 6 1 3 5 7.  Keys from Skv to the padded length
// are written as 0.  hi_of and lo_or_whole split each value.
__global__ void __launch_bounds__(256)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ k_hi, float* __restrict__ k_lo,
                float* __restrict__ vt, float* __restrict__ vt_lo, int skv,
                int skv_pad, int dh) {
  __shared__ float tile[32][33];
  const int64_t kvh = blockIdx.x / (skv_pad / 32);
  const int k0 = (int)(blockIdx.x % (skv_pad / 32)) * 32, d0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    float x = 0.f;
    if (k0 + r < skv) {
      const int64_t i = (kvh * skv + k0 + r) * dh + d0 + tx;
      const float kv = k[i];
      k_hi[i] = hi_of(kv);
      k_lo[i] = lo_or_whole(kv);
      x = v[i];
    }
    tile[r][tx] = x;
  }
  __syncthreads();
  // stored position tx holds key (tx & ~7) + order[tx & 7]
  const int key = (tx & ~7) + ((tx & 4) ? 2 * (tx & 3) + 1 : 2 * (tx & 3));
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const float x = tile[key][r];
    const int64_t i = (kvh * dh + d0 + r) * skv_pad + k0 + tx;
    vt[i] = hi_of(x);
    vt_lo[i] = lo_or_whole(x);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_klo,
               const __grid_constant__ CUtensorMap tm_vt,
               const __grid_constant__ CUtensorMap tm_vtlo,
               float* __restrict__ o, int hq, int group, int sq, int skv,
               int causal, int window, float scale_log2) {
  using C = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t base = (raw0 + 1023) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw0);
  const uint32_t q_s = base;
  const uint32_t bar = base + C::BAR_OFF;
  const uint32_t q_full = bar;
  auto full = [&](int w, int s) { return bar + 8 * (1 + 2 * kStages * w + s); };
  auto empty = [&](int w, int s) {
    return bar + 8 * (1 + 2 * kStages * w + kStages + s);
  };
  auto ring = [&](int w) { return base + C::RING_OFF + w * kStages * kSlot; };

  const int bh = blockIdx.x;  // b * hq + h; kv head b * hkv + h / group
  const int kvh = (bh / hq) * (hq / group) + (bh % hq) / group;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kBQ;
  // the kv tiles any row of this CTA can see; consumer w takes tiles w,
  // w + 2, ...
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full(w, s), 1);
        mbar_init(empty(w, s), 4);  // one arrival a consumer warp
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int w = (threadIdx.x / 32) % 4;  // the consumer it feeds
    if (w < 2 && threadIdx.x % 32 == 0) {
      if (w == 0) {
        mbar_expect_tx(q_full, C::Q_BYTES);
        for (int p = 0; p < C::NP; ++p)
          tma_load(q_s + p * kPanel, &tm_q, q_full, 32 * p, q0, bh);
      }
      // a slot's hi and lo panels
      auto load = [&](uint32_t slot, const CUtensorMap* hi,
                      const CUtensorMap* lo, uint32_t full_bar, int c0,
                      int c1) {
        tma_load(slot, hi, full_bar, c0, c1, kvh);
        tma_load(slot + kLo, lo, full_bar, c0, c1, kvh);
      };
      uint32_t g = 0;  // slots issued
      auto next = [&](uint32_t tx) {
        const int s = g % kStages;
        mbar_wait(empty(w, s), ((g / kStages) & 1) ^ 1);
        mbar_expect_tx(full(w, s), tx);
        ++g;
        return s;
      };
      for (int t = w; t < n_tiles; t += 2) {
        const int k0 = k_begin + t * kBK;
        for (int p = 0; p < C::NP; ++p) {
          const int s = next(C::K_TX);
          load(ring(w) + s * kSlot, &tm_k, &tm_klo, full(w, s), 32 * p, k0);
        }
        for (int kp = 0; kp < 2; ++kp)
          for (int c = 0; c < DH / C::NV; ++c) {
            const int s = next(2 * C::NV * 128);
            load(ring(w) + s * kSlot, &tm_vt, &tm_vtlo, full(w, s),
                 k0 + 32 * kp, C::NV * c);
          }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r0 = 16 * (tid / 32) + lane / 4;  // fragment rows r0, r0 + 8
    const int c2 = 2 * (lane % 4);               // fragment columns 8 j + c2
    const int row[2] = {q0 + r0, q0 + r0 + 8};
    const uint32_t my_ring = ring(wgi);

    // Q's hi and lo, 16-byte chunk by chunk (the swizzle moves whole
    // chunks, so lo lands in Q's layout).  Both consumers split half each.
    mbar_wait(q_full, 0);
    {
      float4* qp = reinterpret_cast<float4*>(base_ptr);
      float4* lp = reinterpret_cast<float4*>(base_ptr + C::QLO_OFF);
      for (int i = threadIdx.x; i < C::Q_BYTES / 16; i += 256) {
        const float4 x = qp[i];
        qp[i] = make_float4(hi_of(x.x), hi_of(x.y), hi_of(x.z), hi_of(x.w));
        lp[i] = make_float4(lo_or_whole(x.x), lo_or_whole(x.y),
                            lo_or_whole(x.z), lo_or_whole(x.w));
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, 256;" ::: "memory");
    }

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sum
    uint32_t g = 0;  // slots consumed
    auto wait_slot = [&]() {
      const int s = g % kStages;
      mbar_wait(full(wgi, s), (g / kStages) & 1);
      return s;
    };
    auto free_slot = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(wgi, s));
      ++g;
    };

    for (int t = wgi; t < n_tiles; t += 2) {
      const int k0 = k_begin + t * kBK;

      // S = Q K^T: each K panel's 12 products (lo hi, hi lo, hi hi for
      // four k8 steps) start from zero and join S in IEEE f32 adds
      float sc[32];
#pragma unroll
      for (int p = 0; p < C::NP; ++p) {
        const int s = wait_slot();
        const uint32_t slot = my_ring + s * kSlot;
        const uint32_t qh = q_s + p * kPanel, ql = qh + C::QLO_OFF;
        float sp[32];  // the panel's products; the first writes over it
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          mma_ss(sp, desc(ql + 32 * kk), desc(slot + 32 * kk), kk > 0);
          mma_ss(sp, desc(qh + 32 * kk), desc(slot + kLo + 32 * kk), 1);
          mma_ss(sp, desc(qh + 32 * kk), desc(slot + 32 * kk), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sp);
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = p == 0 ? sp[i] : sc[i] + sp[i];
        free_slot(s);
      }

      // mask: only tiles that cross Skv, the diagonal or the window edge
      const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > q0) ||
                        (window > 0 && q0 + kBQ - 1 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = k0 + 8 * j + c2 + e;
              bool keep = kpos < skv;
              if (causal) keep = keep && row[i] >= kpos;
              if (window > 0) keep = keep && row[i] - kpos < window;
              if (!keep) sc[4 * j + 2 * i + e] = -INFINITY;
            }
      }

      // online softmax on the fragment (row i: sc[4 j + 2 i + e], the four
      // lanes of a quad share a row), exp2 with scale * log2(e) folded in
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = max_nan(mx, max_nan(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
        mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = max_nan(m_run[i], mx * scale_log2);
        const bool on = live(m_new);
        alpha[i] = live(m_run[i]) ? ex2(m_run[i] - m_new) : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * i + e];
            x = on ? ex2(fmaf(x, scale_log2, -m_new)) : 0.f;
            sum += x;
          }
        l_run[i] = alpha[i] * l_run[i] + sum;
        m_run[i] = m_new;
      }

#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }

      // O += P V, 32 keys at a time: P's 32 keys split into TF32 hi and
      // lo, already the A fragments of the four PV k8 steps (V^T stores
      // each group of 8 keys as 0 2 4 6 1 3 5 7, so fragment columns c and
      // c + 4, keys 2c and 2c + 1, are this thread's S columns 2c, 2c + 1
      // of the step); then each V^T panel's 12 products start from zero
      // and join their chunk of O in IEEE f32 adds
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        uint32_t ph[16], pl[16];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x = sc[16 * kp + 4 * j + (r & 1) * 2 + (r >> 1)];
            const uint32_t h = tf32_hi(__float_as_uint(x));
            ph[4 * j + r] = h;
            pl[4 * j + r] = tf32_rna(x - __uint_as_float(h));
          }
#pragma unroll
        for (int c = 0; c < DH / C::NV; ++c) {
          const int s = wait_slot();
          const uint32_t slot = my_ring + s * kSlot;
          float op[C::NV / 2];  // the panel's products
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            mma_rs(op, pl + 4 * kk, desc(slot + 32 * kk), kk > 0);
            mma_rs(op, ph + 4 * kk, desc(slot + kLo + 32 * kk), 1);
            mma_rs(op, ph + 4 * kk, desc(slot + 32 * kk), 1);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(op);
#pragma unroll
          for (int i = 0; i < C::NV / 2; ++i) acc[C::NV / 2 * c + i] += op[i];
          free_slot(s);
        }
        // the products read ph and pl until the last wait
#pragma unroll
        for (int i = 0; i < 16; ++i)
          asm volatile("" ::"r"(ph[i]), "r"(pl[i]) : "memory");
      }
    }

    // Merge: consumer 1 leaves its (m, l, O) in the Q region, free once
    // both have left the loop; consumer 0 rescales both to the larger m,
    // divides by l (1 where l == 0: a row with no key is zeros) and stores
    // the rows below Sq.
    float* xo = reinterpret_cast<float*>(base_ptr);  // [DH / 2][128]
    float* xm = xo + DH / 2 * 128;                   // [2][128]
    float* xl = xm + 2 * 128;                        // [2][128]
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (wgi == 1) {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) xo[i * 128 + tid] = acc[i];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xm[i * 128 + tid] = m_run[i];
        xl[i * 128 + tid] = l_run[i];
      }
    }
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (wgi == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m1 = xm[i * 128 + tid];
        const float m = max_nan(m_run[i], m1);
        const float a0 = live(m_run[i]) ? ex2(m_run[i] - m) : 0.f;
        const float a1 = live(m1) ? ex2(m1 - m) : 0.f;
        float l = a0 * l_run[i] + a1 * xl[i * 128 + tid];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        if (l == 0.f) l = 1.f;
        if (row[i] >= sq) continue;
        float* out = o + ((int64_t)bh * sq + row[i]) * DH + c2;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          const int n = 4 * j + 2 * i;
          const float x0 = a0 * acc[n] + a1 * xo[n * 128 + tid];
          const float x1 = a0 * acc[n + 1] + a1 * xo[(n + 1) * 128 + tid];
          *reinterpret_cast<float2*>(out + 8 * j) = make_float2(x0 / l, x1 / l);
        }
      }
    }
  }
}

// 3-D map (d0, d1, d2) of a contiguous f32 tensor, box (32, rows, 1),
// 128-byte swizzle: a box past d1 is zero-filled inside its own d2 slice
bool f32_map(CUtensorMap* map, const void* ptr, long long d0, long long d1,
             long long d2, int rows) {
  const wg::EncodeTiled encode = wg::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 4, (cuuint64_t)(d0 * d1) * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int split_kv(const void* k, const void* v, void* k_hi, void* k_lo, void* vt,
             void* vt_lo, long long bhkv, long long skv, long long skv_pad,
             long long dh, cudaStream_t stream) {
  const dim3 grid((unsigned int)(bhkv * (skv_pad / 32)), (unsigned int)(dh / 32));
  split_kv_kernel<<<grid, 256, 0, stream>>>(
      (const float*)k, (const float*)v, (float*)k_hi, (float*)k_lo,
      (float*)vt, (float*)vt_lo, (int)skv, (int)skv_pad, (int)dh);
  return (int)cudaGetLastError();
}

template <int DH>
int launch(const void* q, const void* k_hi, const void* k_lo, const void* vt,
           const void* vt_lo, void* o, long long b, long long hq,
           long long hkv, long long sq, long long skv, long long skv_pad,
           int causal, long long window, float scale, cudaStream_t stream) {
  using C = Cfg<DH>;
  CUtensorMap tq, tk, tkl, tv, tvl;
  if (!f32_map(&tq, q, DH, sq, b * hq, kBQ) ||
      !f32_map(&tk, k_hi, DH, skv, b * hkv, kBK) ||
      !f32_map(&tkl, k_lo, DH, skv, b * hkv, kBK) ||
      !f32_map(&tv, vt, skv_pad, DH, b * hkv, C::NV) ||
      !f32_map(&tvl, vt_lo, skv_pad, DH, b * hkv, C::NV))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_tf32<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)(b * hq), (unsigned int)((sq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, C::SMEM, stream>>>(
      tq, tk, tkl, tv, tvl, (float*)o, (int)hq, (int)(hq / hkv), (int)sq,
      (int)skv, causal, (int)window, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace tf

}  // namespace

#define DISPATCH_DH(fn)                                                      \
  switch (dh) {                                                              \
    case 32:                                                                 \
      return fn<32>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale,  \
                    (cudaStream_t)stream);                                   \
    case 64:                                                                 \
      return fn<64>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale,  \
                    (cudaStream_t)stream);                                   \
    case 128:                                                                \
      return fn<128>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, \
                     (cudaStream_t)stream);                                  \
    case 256:                                                                \
      return fn<256>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, \
                     (cudaStream_t)stream);                                  \
    default:                                                                 \
      return (int)cudaErrorInvalidValue;                                     \
  }

extern "C" {

// Shapes are checked by the wrapper (repro_torch/kernels/flash_attention/
// kernel.py); dh outside {32, 64, 128, 256} returns cudaErrorInvalidValue.
// The f32 route's pre-pass: k, v (B * Hkv, Skv, Dh) f32 to k_hi, k_lo (the
// same shape) and vt, vt_lo (B * Hkv, Dh, Skv_pad), Skv_pad a multiple of
// 32.
int attn_split_kv_f32(const void* k, const void* v, void* k_hi, void* k_lo,
                      void* vt, void* vt_lo, long long bhkv, long long skv,
                      long long skv_pad, long long dh, void* stream) {
  if (dh % 32 || skv_pad % tf::kKeyPad || skv_pad < skv)
    return (int)cudaErrorInvalidValue;
  return tf::split_kv(k, v, k_hi, k_lo, vt, vt_lo, bhkv, skv, skv_pad, dh,
                      (cudaStream_t)stream);
}

// q, o f32 and the pre-pass's k_hi, k_lo, vt, vt_lo, all 16-byte aligned:
// the split-TF32 wgmma + TMA kernel.
int attn_flash_fwd_f32(const void* q, const void* k_hi, const void* k_lo,
                       const void* vt, const void* vt_lo, void* o,
                       long long b, long long hq, long long hkv, long long sq,
                       long long skv, long long skv_pad, long long dh,
                       int causal, long long window, float scale,
                       void* stream) {
#define F32_CASE(D)                                                       \
  case D:                                                                 \
    return tf::launch<D>(q, k_hi, k_lo, vt, vt_lo, o, b, hq, hkv, sq, skv, \
                         skv_pad, causal, window, scale, (cudaStream_t)stream);
  switch (dh) {
    F32_CASE(32)
    F32_CASE(64)
    F32_CASE(128)
    F32_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef F32_CASE
}

// q, k, v, o all bf16, 16-byte aligned: the wgmma + TMA kernel.
int attn_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                        long long b, long long hq, long long hkv, long long sq,
                        long long skv, long long dh, int causal,
                        long long window, float scale, void* stream) {
  DISPATCH_DH(wg::launch_bf16)
}

}  // extern "C"
