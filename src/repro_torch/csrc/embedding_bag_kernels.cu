// Hand-written Hopper (sm_90a) EmbeddingBag kernel of the recsys lookup op.
//
// Built with the other kernels by repro_torch/kernels/_build.py (nvcc
// -gencode arch=compute_90a,code=sm_90a, one object per source, linked into
// one shared library with a plain C interface, loaded with ctypes).  The
// entry point launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// A5 embedding_bag_sum: replaces the Pallas kernel _bag_kernel
// (src/repro/kernels/embedding_bag/kernel.py:28, launched by
// embedding_bag_sum through pallas_call at :49).
//
// idx (B, L) int32, any negative index a pad; table (V, D) f32 or bf16;
// out (B, D) in the table's dtype.  out[b] is the f32 sum, in slot order
// l = 0 .. L-1, of the rows table[idx[b, l]] with idx[b, l] >= 0, rounded
// once to the table's dtype.  The wrapper has checked every index < V.
//
// What differs from the TPU kernel: its grid (B, L) DMAs one row a step,
// the pad slots included (row max(idx, 0)), and adds row * valid, so a pad
// over a non-finite row 0 gives inf * 0 = NaN.  Here a pad's row is never
// read and adds nothing, as the oracle's `where` does (ref.py).  On a finite
// table the two agree bitwise: both add the same f32 rows in the same order.
//
// Bound on the H100: bytes.  Each valid slot reads one row of D elements
// from a random place of a table far larger than the 50 MB L2 (DeepFM's is
// 39,000,000 x 10 f32, 1.56 GB), and there is one add per element read.  A
// 40-byte f32 row at D = 10 is not 16-byte aligned and spans two 32-byte
// sectors wherever it starts, so the card moves 64 bytes for its 40.
// Design: one thread per (bag, column), a block of 256 threads covering
// floor(256 / D) bags (25 at D = 10, 250 threads busy; one bag and a loop
// over the columns for D > 256).  The threads of one bag read one row
// together: D consecutive elements, scalar loads, any D >= 1.  Each thread
// reads its bag's indices (one broadcast load for the bag's threads) and
// keeps kChunk rows' loads in flight before it adds them in slot order, so
// the sum order, and the result, is the plain version's.  No slot is split
// across threads and there are no atomics.  Offsets are int64 (row * D).
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;  // slots whose rows are loaded before they are added

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bag_sum_kernel(const int32_t* __restrict__ idx,
                   const T* __restrict__ table, T* __restrict__ out,
                   int64_t b, int l, int d, int bags_per_block) {
  const int64_t bag0 = (int64_t)blockIdx.x * bags_per_block;
  const int span = bags_per_block * d;
  for (int e = threadIdx.x; e < span; e += kThreads) {
    const int64_t bag = bag0 + e / d;
    if (bag >= b) break;  // bag grows with e
    const int c = e % d;
    const int32_t* ip = idx + bag * l;
    float acc = 0.f;
    for (int l0 = 0; l0 < l; l0 += kChunk) {
      float x[kChunk];
      bool valid[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int32_t i = l0 + j < l ? ip[l0 + j] : -1;
        valid[j] = i >= 0;
        x[j] = valid[j] ? to_f32(table[(int64_t)i * d + c]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (valid[j]) acc += x[j];  // slot order; a pad adds nothing
    }
    store(out + bag * d + c, acc);
  }
}

template <typename T>
int launch(const void* idx, const void* table, void* out, long long b,
           long long l, long long d, cudaStream_t stream) {
  const int bags_per_block = d >= kThreads ? 1 : (int)(kThreads / d);
  const unsigned int grid =
      (unsigned int)((b + bags_per_block - 1) / bags_per_block);
  bag_sum_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const int32_t*)idx, (const T*)table, (T*)out, b, (int)l, (int)d,
      bags_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes, dtypes and index range are checked by the wrapper
// (repro_torch/kernels/embedding_bag/kernel.py): b, l, d >= 1,
// ceil(b / floor(256 / d)) blocks within grid.x, l and d within int.
int emb_bag_sum(const void* idx, const void* table, void* out, long long b,
                long long l, long long d, int bf16, void* stream) {
  if (bf16)
    return launch<__nv_bfloat16>(idx, table, out, b, l, d,
                                 (cudaStream_t)stream);
  return launch<float>(idx, table, out, b, l, d, (cudaStream_t)stream);
}

}  // extern "C"
