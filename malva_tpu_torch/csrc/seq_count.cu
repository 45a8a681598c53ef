// K3: the sample counter's front end.  For each of n_pos windows of a raw
// read chunk (reads joined by 0xFF separators) it writes a validity byte,
// true only for a window of pure A/C/G/T (either case), and the window's
// canonical 2-bit key as W = ceil(ref_k / 32) 64-bit words (zeros for an
// invalid window).
//
// Has no Pallas counterpart: it replaces the XLA front end of
// malva_tpu/count/device_count.py:64 make_seq_sort_count_step, which
// stacks a (chunk, ref_k) byte matrix of the windows and then validates,
// canonicalizes and packs it column by column.  The compaction, sort and
// run count that follow are torch's (count/device_count.py of the port).
//
// Bound: bytes.  At 2^25 windows and ref_k 43 the kernel must read the
// 2^25 + 42 bytes of the chunk once and write 2^25 x (16 B of key + 1 B of
// flag): 603.98 MB, 0.180 ms at the H100's 3.35 TB/s.  A first version
// built each window afresh in its own thread (ref_k byte loads and
// compares, with its code arrays indexed at run time and so in local
// memory) and took 6.16-6.24 ms.  This design:
//
// * Tiles in shared memory.  A block owns a tile of kTile windows at a
//   time; a persistent grid walks the tiles.  The tile's kTile + ref_k - 1
//   bytes come in with 16-byte cp.async copies, and the next tile's copy
//   is issued as soon as the current one is translated, so it lands while
//   the current tile is computed.
// * Translation once per byte.  Each byte becomes its 2-bit code plus an
//   invalid flag one time (lanes.cuh base_codes4, four bytes per step),
//   into a code buffer with 4 pad bytes after every 32, so that the
//   threads' reads fall in distinct banks.
// * Rolling codes in registers.  Each thread owns kPerThread consecutive
//   windows: it pushes the first ref_k - 1 bases, then one base per window
//   (lanes.cuh RollingKey).  N = ceil(ref_k / 16) is a template parameter,
//   instantiated for every ref_k the kernels take (1..240), so no array is
//   indexed at run time and nothing lives in local memory.
// * Coalesced stores.  The keys of a phase of R2 windows per thread go
//   through a shared staging buffer (one pad word per thread, so the
//   threads' 8-byte writes fall in distinct banks), and leave as 16-byte
//   vectors, each thread's run of R2 * W words a whole number of them
//   (one 128-byte line per 8 threads at W = 2).  Each thread writes its
//   32 flags as two 16-byte vectors.
#include <cuda_runtime.h>

#include "lanes.cuh"
#include "launch.cuh"

using namespace malva;

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 32;                    // windows a thread rolls through per tile
constexpr int kTile = kThreads * kPerThread;      // windows per tile
constexpr int kRawBytes = (kTile + kMaxLen - 1 + 15) / 16 * 16;    // a tile's bytes, at most
constexpr int kCodeBytes = (kRawBytes + kRawBytes / 8 + 15) / 16 * 16;  // + 4 pad bytes per 32

template <int N>
struct Layout {
  static constexpr int W = (N + 1) / 2;  // 64-bit words of a key
  // windows per thread per phase: a thread's run of R2 * W words is an
  // even number of words, 80 to 128 bytes
  static constexpr int R2 = W == 1 ? 16 : W == 2 ? 8 : W <= 4 ? 4 : 2;
  static constexpr int kRun = R2 * W + 1;  // staged words per thread, with a pad word
  static constexpr int kSmem = kRawBytes + kCodeBytes + kThreads * kRun * 8;
  static constexpr int kMinBlocks = N <= 8 ? 4 : 2;
};

// Starts the copy of a tile's bytes into `raw` (launch.cuh copy_async).
__device__ void load_tile(uint8_t* raw, const uint8_t* __restrict__ seq, int64_t n_bytes,
                          int64_t tile, int want, bool aligned) {
  const int64_t start = tile * kTile;
  const int n = n_bytes - start < want ? (int)(n_bytes - start) : want;
  copy_async(raw, seq + start, n, aligned);
}

__device__ __forceinline__ uint32_t spread_flags(uint32_t nibble) {  // 4 bits -> 4 bytes of 0/1
  return (nibble * 0x00204081u) & 0x01010101u;
}

template <int N>
__global__ void __launch_bounds__(kThreads, Layout<N>::kMinBlocks)
    seq_pack_kernel(const uint8_t* __restrict__ seq, int64_t n_pos, int ref_k,
                    uint64_t* __restrict__ keys, uint8_t* __restrict__ valid) {
  using L = Layout<N>;
  constexpr int W = L::W, R2 = L::R2;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* raw = smem;
  uint8_t* codes = smem + kRawBytes;
  uint64_t* stage = reinterpret_cast<uint64_t*>(smem + kRawBytes + kCodeBytes);

  const RollShape shape = roll_shape(ref_k);
  const int64_t n_bytes = n_pos + ref_k - 1;
  const int64_t n_tiles = (n_pos + kTile - 1) / kTile;
  const int want = kTile + ref_k - 1;
  const bool aligned = (reinterpret_cast<uintptr_t>(seq) & 15) == 0;
  const int tid = threadIdx.x;
  const int first = tid * kPerThread;  // this thread's first window (and base) in the tile

  int64_t tile = blockIdx.x;
  if (tile < n_tiles) load_tile(raw, seq, n_bytes, tile, want, aligned);
  for (; tile < n_tiles; tile += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();
    for (int q = tid; q < (want + 3) / 4; q += kThreads)
      reinterpret_cast<uint32_t*>(codes)[q + q / 8] =
          base_codes4(reinterpret_cast<const uint32_t*>(raw)[q]);
    __syncthreads();
    if (tile + gridDim.x < n_tiles) load_tile(raw, seq, n_bytes, tile + gridDim.x, want, aligned);

    const int64_t tile_pos = tile * kTile;
    RollingKey<N> st;
    st.reset();
    for (int m = 0; m < ref_k - 1; ++m) {
      const int p = first + m;
      st.push(codes[p + 4 * (p >> 5)], shape);
    }
    uint32_t flags = 0;
#pragma unroll 1
    for (int ph = 0; ph < kPerThread / R2; ++ph) {
#pragma unroll
      for (int r = 0; r < R2; ++r) {
        const int w = ph * R2 + r;
        const int p = first + ref_k - 1 + w;
        st.push(codes[p + 4 * (p >> 5)], shape);
        uint64_t key[W];
        flags |= (uint32_t)st.key(shape, key) << w;
#pragma unroll
        for (int j = 0; j < W; ++j) stage[tid * L::kRun + r * W + j] = key[j];
      }
      __syncthreads();
      // thread t's R2 windows of this phase are one run of R2 * W words
      constexpr int kChunks = R2 * W / 2;  // 16-byte vectors per run
      const int64_t limit = n_pos * W;
      for (int q = tid; q < kThreads * kChunks; q += kThreads) {
        const int run = q / kChunks, c = q % kChunks;
        const uint64_t* src = stage + run * L::kRun + 2 * c;
        const int64_t e = (tile_pos + run * kPerThread + ph * R2) * W + 2 * c;
        if (e + 1 < limit)
          *reinterpret_cast<ulonglong2*>(keys + e) = make_ulonglong2(src[0], src[1]);
        else if (e < limit)
          keys[e] = src[0];
      }
      __syncthreads();
    }
    const int64_t f0 = tile_pos + first;
    if (f0 + kPerThread <= n_pos) {
      uint4* out = reinterpret_cast<uint4*>(valid + f0);
      out[0] = make_uint4(spread_flags(flags & 15), spread_flags((flags >> 4) & 15),
                          spread_flags((flags >> 8) & 15), spread_flags((flags >> 12) & 15));
      out[1] = make_uint4(spread_flags((flags >> 16) & 15), spread_flags((flags >> 20) & 15),
                          spread_flags((flags >> 24) & 15), spread_flags(flags >> 28));
    } else {
      for (int w = 0; w < kPerThread && f0 + w < n_pos; ++w) valid[f0 + w] = (flags >> w) & 1;
    }
  }
}

template <int N>
int launch(const uint8_t* seq, int64_t n_pos, int ref_k, uint64_t* keys, uint8_t* valid,
           cudaStream_t stream) {
  using L = Layout<N>;
  const cudaError_t e = cudaFuncSetAttribute(
      seq_pack_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (e != cudaSuccess) return (int)e;
  int grid = 0;
  const int err = persistent_grid(seq_pack_kernel<N>, kThreads, L::kSmem,
                                  (n_pos + kTile - 1) / kTile, &grid);
  if (err != 0) return err;
  seq_pack_kernel<N><<<grid, kThreads, L::kSmem, stream>>>(seq, n_pos, ref_k, keys, valid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int malva_seq_pack(const void* seq, int64_t n_pos, int ref_k, void* keys, void* valid,
                   void* stream) {
  if (n_pos <= 0) return 0;
  const uint8_t* s = (const uint8_t*)seq;
  uint64_t* k = (uint64_t*)keys;
  uint8_t* v = (uint8_t*)valid;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((ref_k + 15) / 16) {
#define MALVA_K3_CASE(n) \
  case n:                \
    return launch<n>(s, n_pos, ref_k, k, v, st);
    MALVA_K3_CASE(1) MALVA_K3_CASE(2) MALVA_K3_CASE(3) MALVA_K3_CASE(4) MALVA_K3_CASE(5)
    MALVA_K3_CASE(6) MALVA_K3_CASE(7) MALVA_K3_CASE(8) MALVA_K3_CASE(9) MALVA_K3_CASE(10)
    MALVA_K3_CASE(11) MALVA_K3_CASE(12) MALVA_K3_CASE(13) MALVA_K3_CASE(14) MALVA_K3_CASE(15)
#undef MALVA_K3_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
