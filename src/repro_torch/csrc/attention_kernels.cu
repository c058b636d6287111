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
// Dh = 256 and a causal 8192-token prompt about 2000 FLOP per byte, far
// above the ridge of the bf16 tensor cores (295).  Two routes, chosen by
// dtype in the wrapper (kernels/flash_attention/kernel.py):
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
// f32, flash_fwd_kernel: plain f32 FMA on the CUDA cores (TF32 tensor cores
//   would miss the f32 tolerance, and no path of the port runs f32
//   attention).  One CTA of 256 threads owns a 64-row q tile; q, k and v
//   tiles of 32 keys are staged in shared memory, each thread holds 2 q rows
//   x 4 keys of scores and 2 rows x Dh/8 columns of the accumulator.
// ---------------------------------------------------------------------------

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // kernel.py NEG_INF

// ===================================================== f32, CUDA cores

constexpr int kBQ = 64;            // q rows per CTA
constexpr int kBK = 32;            // keys per kv tile
constexpr int kThreads = 256;      // thread (tr, tc) = (tid / 8, tid % 8)
constexpr int kPS = kBK + 1;       // row stride of the p tile (no conflicts)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBQ + kBK) * (DH + 4) + (size_t)kBK * DH + kBQ * kPS);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int hq,
                 int group, int sq, int skv, int causal, int window,
                 float scale) {
  constexpr int QS = DH + 4;   // row stride of the q and k tiles (floats)
  constexpr int C4 = DH / 4;   // float4 per row
  constexpr int NJ = DH / 32;  // float4 accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBQ][QS]
  float* k_s = q_s + kBQ * QS;                   // [kBK][QS]
  float* v_s = k_s + kBK * QS;                   // [kBK][DH]
  float* p_s = v_s + kBK * DH;                   // [kBQ][kPS]

  const int tid = threadIdx.x;
  const int tr = tid >> 3;  // q rows tr and tr + 32 of the tile
  const int tc = tid & 7;   // keys tc + 8 j; accumulator columns 32 j + 4 tc
  const int64_t bh = blockIdx.x;                 // b * hq + h
  const int64_t kvh = (bh / hq) * (hq / group) + (bh % hq) / group;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kBQ;
  const float* qp = q + (bh * sq + q0) * DH;
  const float* kp = k + kvh * skv * DH;
  const float* vp = v + kvh * skv * DH;

  for (int i = tid; i < kBQ * C4; i += kThreads) {
    const int r = i / C4, c = (i % C4) * 4;
    const float4 x = q0 + r < sq ? load4(qp + (int64_t)r * DH + c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(q_s + r * QS + c, x);
  }

  // the keys any row of this tile can see
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;

  const int row[2] = {q0 + tr, q0 + tr + 32};
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float4 acc[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's PV reads (and the q tile) are done
    for (int i = tid; i < kBK * C4; i += kThreads) {
      const int r = i / C4, c = (i % C4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < skv) {
        kx = load4(kp + (int64_t)(k0 + r) * DH + c);
        vx = load4(vp + (int64_t)(k0 + r) * DH + c);
      }
      store4(k_s + r * QS + c, kx);
      store4(v_s + r * DH + c, vx);
    }
    __syncthreads();

    // s = q k^T for rows tr, tr + 32 and keys tc + 8 j
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 qa = load4(q_s + tr * QS + d);
      const float4 qb = load4(q_s + (tr + 32) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kk = load4(k_s + (tc + 8 * j) * QS + d);
        s[0][j] = dot4(qa, kk, s[0][j]);
        s[1][j] = dot4(qb, kk, s[1][j]);
      }
    }

    // online softmax; the 8 lanes tc = 0..7 of a row are adjacent lanes
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m_cur = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc + 8 * j;
        bool keep = kpos < skv;
        if (causal) keep = keep && row[i] >= kpos;
        if (window > 0) keep = keep && row[i] - kpos < window;
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        m_cur = fmaxf(m_cur, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      const float m_new = fmaxf(m_run[i], m_cur);
      const bool live = m_new > kNegInf / 2;
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live ? expf(s[i][j] - m_new) : 0.f;
        p_sum += p;
        p_s[(tr + 32 * i) * kPS + tc + 8 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
      const float alpha =
          m_run[i] > kNegInf / 2 ? expf(m_run[i] - m_new) : 0.f;
      l_run[i] = alpha * l_run[i] + p_sum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j].x *= alpha;
        acc[i][j].y *= alpha;
        acc[i][j].z *= alpha;
        acc[i][j].w *= alpha;
      }
    }
    __syncthreads();

    // acc += p v for rows tr, tr + 32 and columns 32 j + 4 tc .. + 3
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float pa = p_s[tr * kPS + kk];
      const float pb = p_s[(tr + 32) * kPS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 vv = load4(v_s + kk * DH + 32 * j + 4 * tc);
        acc[0][j].x = fmaf(pa, vv.x, acc[0][j].x);
        acc[0][j].y = fmaf(pa, vv.y, acc[0][j].y);
        acc[0][j].z = fmaf(pa, vv.z, acc[0][j].z);
        acc[0][j].w = fmaf(pa, vv.w, acc[0][j].w);
        acc[1][j].x = fmaf(pb, vv.x, acc[1][j].x);
        acc[1][j].y = fmaf(pb, vv.y, acc[1][j].y);
        acc[1][j].z = fmaf(pb, vv.z, acc[1][j].z);
        acc[1][j].w = fmaf(pb, vv.w, acc[1][j].w);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= sq) continue;
    const float l = l_run[i] == 0.f ? 1.f : l_run[i];
    float* out = o + (bh * sq + row[i]) * DH;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 a = acc[i][j];
      store4(out + 32 * j + 4 * tc,
             make_float4(a.x / l, a.y / l, a.z / l, a.w / l));
    }
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               long long b, long long hq, long long hkv, long long sq,
               long long skv, int causal, long long window, float scale,
               cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<DH>;
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)(b * hq), (unsigned int)((sq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (int)hq,
      (int)(hq / hkv), (int)sq, (int)skv, causal, (int)window, scale);
  return (int)cudaGetLastError();
}

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
// q, k, v, o all f32: the CUDA-core kernel.
int attn_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                       long long b, long long hq, long long hkv, long long sq,
                       long long skv, long long dh, int causal,
                       long long window, float scale, void* stream) {
  DISPATCH_DH(launch_f32)
}

// q, k, v, o all bf16, 16-byte aligned: the wgmma + TMA kernel.
int attn_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                        long long b, long long hq, long long hkv, long long sq,
                        long long skv, long long dh, int causal,
                        long long window, float scale, void* stream) {
  DISPATCH_DH(wg::launch_bf16)
}

}  // extern "C"
