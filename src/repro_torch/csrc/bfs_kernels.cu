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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kInf = 1 << 30;  // frontier.INF: unreached
constexpr int kThreads = 256;

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
// (src/repro/kernels/bsr_spmm/kernel.py:38, launched by bsr_spmm).
//
// Y = A @ X with A in block-CSR: K dense 128x128 f32 tiles sorted by block
// row, a block-row pointer `row_ptr` (CSR indptr over block rows, built once
// when the engine is compiled) and each tile's block column.  X is
// (n_x_rows, d) f32, Y is (n_block_rows * 128, d) f32.
//
// The TPU walks the tiles as a sequential grid and zeroes its accumulator on
// a block-row change; blocks on Hopper run in no order, so that schedule is
// not carried over.  Instead one CTA owns one (block row, 64-column tile of
// X) output tile: it loops over that row's tiles, accumulates the 128 x 64
// tile in registers (8 x 4 per thread) and writes it once.  A block row with
// no tile is written as zeros; the all-zero pad tiles that repeat a shard's
// last block row add zeros and need no special case.
//
// Bound on the H100: arithmetic.  Plain f32 FMA (exact for any f32 input,
// not only 0/1) does 2*128*128*d flops per tile against 64 KiB of tile
// bytes, i.e. 2*d/4 = 32 flops per byte at d = 64, above the f32 CUDA-core
// ridge of 67 TFLOP/s / 3.35 TB/s = 20.  The tiles are staged through shared
// memory in 32-column slices with coalesced 128-byte loads; X slices come
// from L2 (a 100k x 64 f32 frontier is 25.6 MB).  bf16 tensor cores (exact
// for 0/1 operands) are the later redesign.
// ---------------------------------------------------------------------------
constexpr int kBM = 128;  // tile rows == tile columns (the block size)
constexpr int kBK = 32;   // tile columns staged per shared-memory slice
constexpr int kBN = 64;   // output columns per CTA
constexpr int kTM = 8;    // output rows per thread
constexpr int kTN = 4;    // output columns per thread

__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const float* __restrict__ blocks,
                const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ block_cols,
                const float* __restrict__ x, float* __restrict__ y,
                int64_t d) {
  __shared__ float a_s[kBM][kBK + 1];
  __shared__ float x_s[kBK][kBN];
  const int tid = threadIdx.x;
  const int tr = tid / (kBN / kTN);  // 0..15: rows tr*8 .. tr*8+7
  const int tc = tid % (kBN / kTN);  // 0..15: cols tc*4 .. tc*4+3
  const int64_t br = blockIdx.x;
  const int64_t col0 = (int64_t)blockIdx.y * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int32_t start = row_ptr[br];
  const int32_t end = row_ptr[br + 1];
  for (int32_t t = start; t < end; ++t) {
    const float* a = blocks + (int64_t)t * kBM * kBM;
    const int64_t xrow0 = (int64_t)block_cols[t] * kBM;
    for (int k0 = 0; k0 < kBM; k0 += kBK) {
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, k = i % kBK;
        a_s[r][k] = a[(int64_t)r * kBM + k0 + k];
      }
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int k = i / kBN, c = i % kBN;
        const int64_t col = col0 + c;
        x_s[k][c] = col < d ? x[(xrow0 + k0 + k) * d + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float av[kTM], xv[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) av[i] = a_s[tr * kTM + i][k];
#pragma unroll
        for (int j = 0; j < kTN; ++j) xv[j] = x_s[k][tc * kTN + j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t row = br * kBM + tr * kTM + i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t col = col0 + tc * kTN + j;
      if (col < d) y[row * d + col] = acc[i][j];
    }
  }
}

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

int bfs_bsr_spmm(const void* blocks, const void* row_ptr,
                 const void* block_cols, const void* x, void* y,
                 long long n_block_rows, long long d, void* stream) {
  const dim3 grid((unsigned int)n_block_rows,
                  (unsigned int)((d + kBN - 1) / kBN));
  bsr_spmm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)blocks, (const int32_t*)row_ptr,
      (const int32_t*)block_cols, (const float*)x, (float*)y, d);
  return (int)cudaGetLastError();
}

int bfs_bitpack(const void* mask, void* out, long long w, long long s,
                void* stream) {
  bitpack_kernel<<<grid_for(w * s), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)mask, (uint32_t*)out, w, s);
  return (int)cudaGetLastError();
}

const char* bfs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
