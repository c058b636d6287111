// Hand-written Hopper (sm_90a) EmbeddingBag kernels of the recsys lookup op.
//
// Built with the other kernels by repro_torch/kernels/_build.py (nvcc
// -gencode arch=compute_90a,code=sm_90a, one object per source, linked into
// one shared library with a plain C interface, loaded with ctypes).  The
// entry points launch on the caller's stream, allocate nothing and return
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
// 40-byte f32 row at D = 10 spans two 32-byte sectors wherever it starts,
// so the card moves 64 bytes for its 40.  The gather is latency-bound
// unless many row fetches are in flight on each SM (about 25 KB at 3.35
// TB/s and 1 us of loaded latency); with enough in flight, the rate at
// which HBM serves random sectors sets the pace, below the byte rate.
//
// Two routes, chosen by the wrapper from the shape (and the table's size
// and alignment), never by a failure; both count in
// embedding_bag_sum.launches.  kernel.py's bag_geometry() holds the rule,
// placed by route_bench.py's timings of both routes on an H100: the gather
// for rows of at most 16 bytes, and of at most 40 bytes on a table larger
// than 48 MiB; plain loads for the rest.
//
// * bag_gather_kernel: an asynchronous row gather staged through shared
//   memory.  It takes rows whose byte width and table address a 4-, 8- or
//   16-byte granule divides, up to kernel.py's MAX_ROW_BYTES (the rule
//   gives it narrow rows only; route_bench times it at every width).
//   The wrapper's gather_geometry() computes its tiling:
//     - A tile is `bags` consecutive bags; a work item is a tile and a
//       chunk of `slots` slots (one chunk of all L slots when a tile holds
//       more than one bag; a bag whose rows outgrow a stage is one tile cut
//       into `chunks` chunks).  An item's indices are one contiguous span
//       of idx.
//     - A persistent grid walks the tiles (tile blockIdx.x, + gridDim.x,
//       ...), and a ring of `stages` stages carries over from one item to
//       the next.  Each stage has an index buffer, a row buffer and one
//       mbarrier, which completes twice an item: its phase of parity 0 when
//       the indices have landed, of parity 1 when the rows have.
//     - Indices: the span is copied with coalesced 16-byte cp.async over
//       its 16-byte-aligned middle and 4-byte cp.async for the unaligned
//       head and tail; element k of the span lands at word (mis + k), mis
//       the span's start in words past a 16-byte boundary, so the 16-byte
//       pieces stay aligned in shared memory.
//     - Rows: as soon as an item's indices have landed, every valid slot's
//       row is copied with cp.async in granules of 16, 8 or 4 bytes (the
//       widest that divides the row's bytes), consecutive threads on
//       consecutive granules of a row, all back to back; a pad's row is
//       never read.  Items j + 1 .. j + stages - 2's rows and item j +
//       stages - 1's indices are in flight while item j is waited for and
//       summed.  kernel.py sets three stages of about 32 KB and two CTAs
//       an SM: 19 bags a stage on DeepFM's bags, some 120 KB of rows in
//       flight an SM.
//     - Sum: one thread per (bag, column), from shared memory, in slot
//       order with f32 accumulation; a bag cut into chunks keeps its
//       partial sums in shared memory between chunks (the same thread owns
//       the same column).  No slot is split across threads and there are no
//       atomics, so the sum order, and the result, is the plain version's.
// * bag_sum_kernel (the plain-load route, this op's first kernel): for
//   every shape the rule does not give the gather, bf16 with odd D (no
//   4-byte granule fits) among them.  One
//   thread per (bag, column), a block of 256 threads covering floor(256 /
//   D) bags; each thread keeps kChunk rows' scalar loads in flight before
//   it adds them in slot order.
//
// Offsets into idx, the table and out are int64 (row * D passes 2^31 on a
// table of more than 2^31 elements).
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;   // bag_sum_kernel: slots loaded before they add
constexpr int kBarBytes = 64;  // the ring's mbarriers (up to 8), at the base

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one asynchronous copy of G bytes, global to shared (both G-aligned)
template <int G>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_u32(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                     smem_u32(dst)), "l"(src), "n"(G)
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

// One work item of the gather: bags [b0, b0 + nb), slots [l0, l0 + nl),
// whose indices are the span idx[s0, s0 + nb * nl).
struct Item {
  int64_t b0, s0;
  int nb, nl;
  bool first, last;  // the tile's first and last chunk
};

template <typename T, int G>
__global__ void __launch_bounds__(kThreads, 2)
    bag_gather_kernel(const int32_t* __restrict__ idx,
                      const T* __restrict__ table, T* __restrict__ out,
                      int64_t b, int l, int d, int stages, int bags,
                      int slots, int chunks, int idx_words,
                      int row_stage_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int32_t* sidx = reinterpret_cast<int32_t*>(smem + kBarBytes);
  unsigned char* srows =
      smem + kBarBytes + (size_t)stages * idx_words * sizeof(int32_t);
  float* acc = reinterpret_cast<float*>(srows +
                                        (size_t)stages * row_stage_bytes);
  const int tid = threadIdx.x;
  const int row_bytes = d * (int)sizeof(T);
  const int gpr = row_bytes / G;  // granules a row
  // rows of at most kThreads granules: this thread's granule of a row and
  // first slot, a pass covering slot_step slots (threads past slot_step *
  // gpr copy nothing); wider rows: a pass a row
  const bool narrow = gpr <= kThreads;
  const int slot_step = narrow ? kThreads / gpr : 1;
  const int piece = narrow ? tid % gpr : 0;
  const int slot0 =
      !narrow ? 0 : tid / gpr < slot_step ? tid / gpr : INT32_MAX;

  const int64_t n_tiles = (b + bags - 1) / bags;
  const int64_t my_tiles =
      n_tiles > blockIdx.x ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t n_items = my_tiles * chunks;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       smem_u32(&bar[i])), "r"(kThreads)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto item = [&](int64_t j) {
    Item it;
    const int64_t tile = blockIdx.x + (j / chunks) * gridDim.x;
    const int chunk = (int)(j % chunks);
    it.b0 = tile * bags;
    it.nb = (int)(b - it.b0 < bags ? b - it.b0 : bags);
    const int l0 = chunk * slots;
    it.nl = l - l0 < slots ? l - l0 : slots;
    it.s0 = it.b0 * l + l0;  // nb == 1 or nl == l: the span is contiguous
    it.first = chunk == 0;
    it.last = chunk == chunks - 1;
    return it;
  };
  // words between the span's start and the 16-byte boundary before it
  auto head = [&](const Item& it) {
    return (int)((reinterpret_cast<uintptr_t>(idx + it.s0) >> 2) & 3);
  };

  // the span's indices into stage st's buffer, element k at word mis + k
  auto issue_idx = [&](const Item& it, int st) {
    const int mis = head(it), n = it.nb * it.nl;
    const int32_t* g0 = idx + it.s0 - mis;  // 16-byte aligned
    int32_t* s = sidx + st * idx_words;
    for (int q = tid; q * 4 < mis + n; q += kThreads) {
      const int k0 = q * 4 - mis;  // the span element of word 4q
      if (k0 >= 0 && k0 + 4 <= n) {
        cp_async<16>(s + q * 4, g0 + q * 4);
      } else {
        for (int e = 0; e < 4; ++e)
          if (k0 + e >= 0 && k0 + e < n) cp_async<4>(s + q * 4 + e,
                                                     g0 + q * 4 + e);
      }
    }
    cp_async_arrive(smem_u32(&bar[st]));
  };

  // every valid slot's row into stage st's row buffer, slot k at k * row
  auto issue_rows = [&](const Item& it, int st) {
    const int32_t* s = sidx + st * idx_words + head(it);
    unsigned char* r = srows + (size_t)st * row_stage_bytes + piece * G;
    const char* tb = reinterpret_cast<const char*>(table) + piece * G;
    const int n = it.nb * it.nl;
    for (int k = slot0; k < n; k += slot_step) {
      const int32_t row = s[k];
      if (row < 0) continue;
      if (narrow)
        cp_async<G>(r + (size_t)k * row_bytes, tb + (int64_t)row * row_bytes);
      else
        for (int p = tid * G; p < row_bytes; p += kThreads * G)
          cp_async<G>(r + (size_t)k * row_bytes + p,
                      tb + (int64_t)row * row_bytes + p);
    }
    cp_async_arrive(smem_u32(&bar[st]));
  };

  // one thread per (bag, column): the chunk's slots in order, f32; kChunk
  // slots' loads from shared memory are issued before they are added
  auto sum = [&](const Item& it, int st) {
    const int32_t* s = sidx + st * idx_words + head(it);
    const T* r = reinterpret_cast<const T*>(srows +
                                            (size_t)st * row_stage_bytes);
    for (int e = tid; e < it.nb * d; e += kThreads) {
      const int bag = e / d, c = e - bag * d;
      float a = it.first ? 0.f : acc[e];
      const int32_t* si = s + bag * it.nl;
      const T* ri = r + (size_t)bag * it.nl * d + c;
      int ll = 0;
      for (; ll + kChunk <= it.nl; ll += kChunk) {
        float x[kChunk];
        bool v[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          v[j] = si[ll + j] >= 0;
          x[j] = to_f32(ri[(size_t)(ll + j) * d]);  // a pad's: unused
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (v[j]) a += x[j];
      }
      for (; ll < it.nl; ++ll)
        if (si[ll] >= 0) a += to_f32(ri[(size_t)ll * d]);
      if (it.last)
        store(out + (it.b0 + bag) * d + c, a);
      else
        acc[e] = a;  // chunks > 1: one bag a tile, e == c
    }
  };

  // Item j + stages - 1's indices and item j + stages - 2's rows are
  // issued while item j is waited for and summed.
  if (n_items == 0) return;
  for (int i = 0; i < stages - 1 && i < n_items; ++i) issue_idx(item(i), i);
  for (int i = 0; i < stages - 2 && i < n_items; ++i) {
    mbar_wait(smem_u32(&bar[i]), 0);
    issue_rows(item(i), i);
  }
  for (int64_t j = 0; j < n_items; ++j) {
    const int st = (int)(j % stages);
    // stage (j - 1) % stages held item j - 1, summed before the last
    // barrier
    const int64_t ji = j + stages - 1, jr = j + stages - 2;
    if (ji < n_items) issue_idx(item(ji), (int)(ji % stages));
    if (jr < n_items) {
      mbar_wait(smem_u32(&bar[jr % stages]), 0);
      issue_rows(item(jr), (int)(jr % stages));
    }
    mbar_wait(smem_u32(&bar[st]), 1);
    sum(item(j), st);
    __syncthreads();  // stage st is free again
  }
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
int launch_loads(const void* idx, const void* table, void* out, long long b,
                 long long l, long long d, cudaStream_t stream) {
  const int bags_per_block = d >= kThreads ? 1 : (int)(kThreads / d);
  const unsigned int grid =
      (unsigned int)((b + bags_per_block - 1) / bags_per_block);
  bag_sum_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const int32_t*)idx, (const T*)table, (T*)out, b, (int)l, (int)d,
      bags_per_block);
  return (int)cudaGetLastError();
}

// bag_gather_kernel's launch, as gather_geometry() computed it
struct Gather {
  const void* idx;
  const void* table;
  void* out;
  long long b, l, d, stages, bags, slots, chunks, idx_words, row_stage_bytes,
      smem, grid;
};

template <typename T, int G>
int launch_gather(const Gather& a, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      bag_gather_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)a.smem);
  if (err != cudaSuccess) return (int)err;
  bag_gather_kernel<T, G><<<(unsigned int)a.grid, kThreads, (size_t)a.smem,
                            stream>>>(
      (const int32_t*)a.idx, (const T*)a.table, (T*)a.out, a.b, (int)a.l,
      (int)a.d, (int)a.stages, (int)a.bags, (int)a.slots, (int)a.chunks,
      (int)a.idx_words, (int)a.row_stage_bytes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gather(const Gather& a, long long granule, cudaStream_t stream) {
  switch (granule) {
    case 16: return launch_gather<T, 16>(a, stream);
    case 8: return launch_gather<T, 8>(a, stream);
    case 4: return launch_gather<T, 4>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shapes, dtypes and index range are checked by the wrapper
// (repro_torch/kernels/embedding_bag/kernel.py), and it computes the
// tiling (gather_geometry): b, l, d >= 1 within int, a granule of 4, 8 or 16
// bytes dividing d * itemsize and the table's address, a ring within 227 KB
// of shared memory, grid >= 1.
int emb_bag_gather(const void* idx, const void* table, void* out,
                   long long b, long long l, long long d, int bf16,
                   long long granule, long long stages, long long bags,
                   long long slots, long long chunks, long long idx_words,
                   long long row_stage_bytes, long long smem, long long grid,
                   void* stream) {
  const Gather a{idx,    table, out,    b,         l,
                 d,      stages, bags,  slots,     chunks,
                 idx_words, row_stage_bytes, smem, grid};
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_gather<__nv_bfloat16>(a, granule, st)
              : launch_gather<float>(a, granule, st);
}

// The plain-load route (bag_sum_kernel): ceil(b / floor(256 / d)) blocks
// within grid.x, l and d within int.
int emb_bag_sum(const void* idx, const void* table, void* out, long long b,
                long long l, long long d, int bf16, void* stream) {
  if (bf16)
    return launch_loads<__nv_bfloat16>(idx, table, out, b, l, d,
                                       (cudaStream_t)stream);
  return launch_loads<float>(idx, table, out, b, l, d, (cudaStream_t)stream);
}

}  // extern "C"
