// Hand-written Hopper (sm_90a) attention kernel of the LM prefill path.
//
// Built with the BFS kernels by repro_torch/kernels/_build.py (nvcc
// -gencode arch=compute_90a,code=sm_90a, one object per source, linked into
// one shared library with a plain C interface, loaded with ctypes).  The
// entry point launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// A4 flash attention forward: replaces the Pallas kernel _flash_kernel
// (src/repro/kernels/flash_attention/kernel.py:31, launched by
// flash_attention).
//
// q (B, Hq, Sq, Dh), k and v (B, Hkv, Skv, Dh), all f32 or all bf16,
// contiguous; o (B, Hq, Sq, Dh) in q's dtype.  q head h reads kv head
// h / (Hq / Hkv) of the same batch row (kernel.py:106-107).  The mask keeps
// a key when q_pos >= k_pos (causal) and q_pos - k_pos < window
// (window > 0), positions counted from 0 in q and in k alike.  The softmax
// is online with f32 running max m, sum l and accumulator; masked scores
// are NEG_INF = -1e30 (not -inf), p is zeroed while m is still NEG_INF and
// alpha is zeroed while the previous m is (kernel.py:63-66), and a row that
// sees no key is written as zeros (l == 0, kernel.py:78).  p is rounded to
// v's dtype before the PV product (kernel.py:69-71) while l sums the f32 p,
// as on the TPU.
//
// What the TPU schedule does not carry over: the Pallas grid walks every kv
// block of every q block in order and asserts Sq, Skv % block == 0.  Here
// one CTA owns one (batch x q head, 64-row q tile); it loops over only the
// 32-key tiles that the causal and window masks leave visible (for a
// 1024-token window that is ~34 tiles instead of Skv / 32), and rows and
// keys past Sq and Skv are bounds-checked, so any Sq, Skv >= 1 is taken.
// Skipping a tile that is masked for every row is exact: such a tile leaves
// (m, l, acc) unchanged in the TPU kernel too.  The q tiles are walked from
// the last (the longest causal row) to the first, to shorten the tail.
//
// Bound on the H100: arithmetic.  The work is 4 * Dh FLOP per visible
// (q, k) pair against 2 * Dh * (Sq + 2 Skv) input bytes per head: at
// Dh = 256 and a causal 8191-token prompt that is ~2000 FLOP per byte, far
// above the ridge of either the f32 CUDA cores (20) or the bf16 tensor cores
// (295).  This first kernel is plain f32 FMA on the CUDA cores: q, k and v
// tiles are staged in shared memory as f32 (bf16 is widened on load), each
// thread holds 2 q rows x 4 keys of scores and 2 rows x Dh/8 columns of
// the accumulator in registers.  At Dh = 256 the 64 x 256 f32 accumulator
// is spread over 256 threads (64 registers each) and the tiles take 141 KB
// of shared memory (dynamic, opted in), one CTA per SM.  Tensor cores
// (wgmma), TMA and a pipelined producer warp are the later redesign.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // kernel.py NEG_INF
constexpr int kBQ = 64;            // q rows per CTA
constexpr int kBK = 32;            // keys per kv tile
constexpr int kThreads = 256;      // thread (tr, tc) = (tid / 8, tid % 8)
constexpr int kPS = kBK + 1;       // row stride of the p tile (no conflicts)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// p.astype(v.dtype), read back as f32 for the FMA
__device__ __forceinline__ float to_v_dtype(float x, const float*) { return x; }
__device__ __forceinline__ float to_v_dtype(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq, int group,
                 int sq, int skv, int causal, int window, float scale) {
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
  const T* qp = q + (bh * sq + q0) * DH;
  const T* kp = k + kvh * skv * DH;
  const T* vp = v + kvh * skv * DH;

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
        p_s[(tr + 32 * i) * kPS + tc + 8 * j] = to_v_dtype(p, v);
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
    T* out = o + (bh * sq + row[i]) * DH;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 a = acc[i][j];
      store4(out + 32 * j + 4 * tc,
             make_float4(a.x / l, a.y / l, a.z / l, a.w / l));
    }
  }
}

template <typename T, int DH>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 long long b, long long hq, long long hkv, long long sq,
                 long long skv, int causal, long long window, float scale,
                 cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DH>;
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)(b * hq), (unsigned int)((sq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (int)hq, (int)(hq / hkv),
      (int)sq, (int)skv, causal, (int)window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dh(const void* q, const void* k, const void* v, void* o,
                long long b, long long hq, long long hkv, long long sq,
                long long skv, long long dh, int causal, long long window,
                float scale, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch_flash<T, 32>(q, k, v, o, b, hq, hkv, sq, skv, causal,
                                 window, scale, stream);
    case 64:
      return launch_flash<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, causal,
                                 window, scale, stream);
    case 128:
      return launch_flash<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, causal,
                                  window, scale, stream);
    case 256:
      return launch_flash<T, 256>(q, k, v, o, b, hq, hkv, sq, skv, causal,
                                  window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shapes are checked by the wrapper (repro_torch/kernels/flash_attention/
// kernel.py); dh outside {32, 64, 128, 256} returns cudaErrorInvalidValue.
int attn_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   long long b, long long hq, long long hkv, long long sq,
                   long long skv, long long dh, int bf16, int causal,
                   long long window, float scale, void* stream) {
  if (bf16)
    return dispatch_dh<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, skv, dh,
                                      causal, window, scale,
                                      (cudaStream_t)stream);
  return dispatch_dh<float>(q, k, v, o, b, hq, hkv, sq, skv, dh, causal,
                            window, scale, (cudaStream_t)stream);
}

}  // extern "C"
