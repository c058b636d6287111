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
// over the sources.
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
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
                       uint32_t* __restrict__ out, int64_t k,
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

// dynamic shared memory of one bsr_expand_bits CTA
int bfs_expand_bits_smem() { return (int)sizeof(ExpandShared); }

// The frontier's OR over the sources, then the expansion; front_any
// (n_fwords int32) is scratch.  The caller launches only with k > 0 tiles.
int bfs_bsr_expand_bits(const void* bits, const void* col_mask,
                        const void* block_rows, const void* block_cols,
                        const void* fwords, void* out, void* front_any,
                        long long k, long long n_fwords,
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
      (const uint32_t*)fwords, (const uint4*)front_any, (uint32_t*)out, k,
      group_block_rows, n_valid, n_blocks, seg, w, s);
  return (int)cudaGetLastError();
}

const char* bfs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
