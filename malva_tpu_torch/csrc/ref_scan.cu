// K2: the reference context scan over a chunk of the reference.
//
// Replaces malva_tpu/ops/pallas_kernels.py:222 make_window_hash_fn together
// with the XLA rest of index/device.py:697 make_ref_scan_step_pallas.  Per
// position: the strcmp/RCN canonical form of the centred k-mer and its
// XXH3, the alt-filter probe, and for a hit the canonical ref_k-window's
// XXH3 and an atomicOr of its bit into the context filter.  The TPU's
// uint32 widening, 128-lane halo and sort+dedup scatter-OR were Mosaic
// workarounds; here the chunk is read as bytes and a hit is one atomicOr.
//
// Bound.  The least work is one canonical form and one XXH3 of k bytes per
// position (chip_smoke.py counts it: 0.0049 ms per 2^20 positions at k =
// 35, set by operations), but the practical floor is the random 4-byte
// alt-filter read per position into a GiB-sized array: its 32-byte sectors
// alone, ~33.5 MB per 2^20 positions, take 0.010 ms at 3.35 TB/s, and the
// card serves such reads at a lower rate still (chip_smoke.py times
// torch's gather of the same words beside the kernel, `gather_ms`).  This
// design keeps the hashing cheap and out of the reads' way:
//
// * Tiles in shared memory.  A persistent grid walks tiles of kTile
//   positions; a tile's bytes and its ref_k - 1 halo bytes come in with
//   16-byte cp.async copies (single bytes where the chunk start is not 16-
//   byte aligned: the sharded scan passes views at any offset), into one
//   of two buffers, so the next tile lands while this one is hashed.
// * The reverse complement built once per byte.  Beside the tile, its
//   RCN-reversed copy, a word at a time (lanes.cuh rcn_reverse4); a
//   window's reverse complement is then a contiguous slice of it.
// * Per position, no copies.  The strcmp decision compares eight bytes of
//   the two slices at a time and stops at the first that differ; XXH3
//   reads the winner straight from shared memory through aligned word
//   loads and funnel shifts (lanes.cuh WordBytes).  Neighbouring threads
//   take neighbouring positions, so a warp's loads fall in few words.
// * Filter reads in flight while hashing.  A thread takes its positions
//   of a tile in groups of kGroup: it issues a group's alt-filter reads
//   together, hashes the next group while they are in flight, then tests
//   them.  The loops over a group are not unrolled (the hashes go to
//   registers by unrolled selects), so the hashing code is there once.
// * Hits compacted.  A warp queues its hit positions of the tile in
//   shared memory, then hashes their ref_k windows from the same tile and
//   sets their bits with every lane busy, rather than once per position
//   slot with most lanes idle.
//
// The hash-only mode (the TPU kernel's outputs, for the checks) runs the
// same tile code and writes four planes.
//
// The codes mode is the first launch of K8 (scan_pack, the sharded scan's
// entry; route.cu partitions its output): the scan's tile code, but where
// the scan sets a bit it writes the context's Bloom index as the
// position's 8-byte code, and a position that misses writes ~0.  K9
// (scan_set, below) sets the bits on the shard that owns them, from the
// slot blocks K8's partition wrote and the copies brought: one atomicOr a
// row, as the scan's own.  K8 is bound like the scan, by the alt-filter
// read per position (a 32-byte sector); its two launches add 8 bytes of
// code written and read per position, the price of reusing K6's tile
// logic for the partition rather than fusing it here.  K9 is bound by
// one 32-byte sector a row; at the main path's hit counts its launch
// costs more than its work.
#include <cuda_runtime.h>

#include "lanes.cuh"
#include "launch.cuh"

using namespace malva;

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;                  // positions a thread takes per tile
constexpr int kGroup = 4;                      // positions hashed before their reads
constexpr int kTile = kThreads * kPerThread;   // positions per tile
// a tile's bytes with the halo, at most, and 16 bytes the readers may touch past them
constexpr int kBufWords = ((kTile + kMaxLen - 1 + 15) / 16 * 16 + 16) / 4;

enum Mode { kScan, kHashOnly, kCodes };

struct Tiles {
  uint32_t raw[2][kBufWords];  // the chunk's bytes, two tiles in turn
  uint32_t rev[kBufWords];     // the current tile's RCN-reversed copy
  int hits[kThreads / 32][32 * kPerThread];  // each warp's hit positions in the tile
  uint8_t rcn[256];
};

template <Mode kMode>
__device__ void scan_tiles(const uint8_t* __restrict__ seq, int64_t n_pos, int k, int ref_k,
                           const uint32_t* __restrict__ bf_words, uint32_t* __restrict__ ctx_words,
                           uint64_t size_bits, uint32_t* __restrict__ out,
                           uint64_t* __restrict__ codes) {
  __shared__ __align__(16) Tiles sm;
  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += kThreads) sm.rcn[i] = rcn((uint8_t)i);

  const int64_t n_bytes = n_pos + ref_k - 1;
  const int64_t n_tiles = (n_pos + kTile - 1) / kTile;
  const int want = kTile + ref_k - 1, off = (ref_k - k) / 2;
  const bool aligned = (reinterpret_cast<uintptr_t>(seq) & 15) == 0;
  auto raw = [&](int b) { return reinterpret_cast<uint8_t*>(sm.raw[b]); };
  auto tile_bytes = [&](int64_t tile) {
    const int64_t left = n_bytes - tile * kTile;
    return left < want ? (int)left : want;
  };

  int64_t tile = blockIdx.x;
  if (tile < n_tiles) copy_async(raw(0), seq + tile * kTile, tile_bytes(tile), aligned);
  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // the tile has landed; the previous tile's readers are done
    const uint32_t* fwd = sm.raw[buf];
    const int E = (tile_bytes(tile) + 3) & ~3;
    for (int q = tid; q < E / 4; q += kThreads) sm.rev[q] = rcn_reverse4(fwd[E / 4 - 1 - q], sm.rcn);
    __syncthreads();
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles) copy_async(raw(buf ^ 1), seq + next * kTile, tile_bytes(next), aligned);

    const int64_t first = tile * kTile;
    const int n_here = n_pos - first < kTile ? (int)(n_pos - first) : kTile;
    if constexpr (kMode == kHashOnly) {
#pragma unroll 1
      for (int p = tid; p < n_here; p += kThreads) {
        const uint64_t c = window_hash_at(fwd, sm.rev, E, p + off, k);
        const uint64_t x = window_hash_at(fwd, sm.rev, E, p, ref_k);
        const int64_t at = first + p;
        out[at] = (uint32_t)(c >> 32);
        out[n_pos + at] = (uint32_t)c;
        out[2 * n_pos + at] = (uint32_t)(x >> 32);
        out[3 * n_pos + at] = (uint32_t)x;
      }
    } else {
      // The centre hashes of a group of kGroup positions, each this
      // thread's position g + r of the tile; the loop is not unrolled, so
      // the hashing code is there once, and put() keeps h in registers.
      auto hash_group = [&](int g, uint64_t (&h)[kGroup]) {
#pragma unroll 1
        for (int r = 0; r < kGroup; ++r) {
          const int p = (g + r) * kThreads + tid;
          if (p < n_here) put(h, r, window_hash_at(fwd, sm.rev, E, p + off, k));
        }
      };
      // a software pipeline: a group's filter reads are in flight while
      // the next group is hashed; the hits are queued for the warp
      int* hits = sm.hits[tid >> 5];
      int n_hits = 0;
      uint64_t c[kGroup] = {};
      hash_group(0, c);
#pragma unroll 1
      for (int g = 0; g < kPerThread; g += kGroup) {
        uint32_t word[kGroup];
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
          word[r] = (g + r) * kThreads + tid < n_here
                        ? __ldg(bf_words + (bloom_index(c[r], size_bits) >> 5)) : 0u;
        uint64_t cn[kGroup] = {};
        if (g + kGroup < kPerThread) hash_group(g + kGroup, cn);
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          const bool hit = (word[r] >> (bloom_index(c[r], size_bits) & 31)) & 1u;
          const unsigned go = __ballot_sync(0xFFFFFFFFu, hit);
          const int at = n_hits + __popc(go & ((1u << (tid & 31)) - 1u));
          if (hit) hits[at] = (g + r) * kThreads + tid;
          else if (kMode == kCodes && (g + r) * kThreads + tid < n_here)
            codes[first + (g + r) * kThreads + tid] = ~0ull;
          n_hits += __popc(go);
        }
#pragma unroll
        for (int r = 0; r < kGroup; ++r) c[r] = cn[r];
      }
      // the warp's hits, every lane busy: the window's hash, one bit set
      __syncwarp();
#pragma unroll 1
      for (int e = tid & 31; e < n_hits; e += 32) {
        const uint64_t cidx = bloom_index(window_hash_at(fwd, sm.rev, E, hits[e], ref_k), size_bits);
        if constexpr (kMode == kCodes)
          codes[first + hits[e]] = cidx;
        else
          atomicOr(ctx_words + (cidx >> 5), 1u << (cidx & 31));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    window_hash_kernel(const uint8_t* __restrict__ seq, int64_t n_pos, int k, int ref_k,
                       uint32_t* __restrict__ out) {
  scan_tiles<kHashOnly>(seq, n_pos, k, ref_k, nullptr, nullptr, 0, out, nullptr);
}

__global__ void __launch_bounds__(kThreads)
    ref_scan_kernel(const uint8_t* __restrict__ seq, int64_t n_pos, int k, int ref_k,
                    const uint32_t* __restrict__ bf_words, uint32_t* __restrict__ ctx_words,
                    uint64_t size_bits) {
  scan_tiles<kScan>(seq, n_pos, k, ref_k, bf_words, ctx_words, size_bits, nullptr, nullptr);
}

__global__ void __launch_bounds__(kThreads)
    scan_codes_kernel(const uint8_t* __restrict__ seq, int64_t n_pos, int k, int ref_k,
                      const uint32_t* __restrict__ bf_words, uint64_t size_bits,
                      uint64_t* __restrict__ codes) {
  scan_tiles<kCodes>(seq, n_pos, k, ref_k, bf_words, nullptr, size_bits, nullptr, codes);
}

// K9: the live rows of n_blocks received slot blocks (kSlotHead header
// words, then W planes of cap words: a shard-local bit index, low word
// first), each bit ORed into the shard's context words.  blockIdx.y is
// the slot block; the blocks of x stride over its rows.
constexpr int kSetThreads = 256;
constexpr int kSetBlocksX = 64;

template <int W>
__global__ void __launch_bounds__(kSetThreads)
    scan_set_kernel(const uint32_t* __restrict__ slots, int64_t cap,
                    uint32_t* __restrict__ ctx_words) {
  const uint32_t* blk = slots + (int64_t)blockIdx.y * (kSlotHead + cap * W);
  const uint32_t head = __ldg(blk);
  const int64_t rows = head < cap ? head : cap;
  for (int64_t i = (int64_t)blockIdx.x * kSetThreads + threadIdx.x; i < rows;
       i += (int64_t)gridDim.x * kSetThreads) {
    uint64_t local = __ldg(blk + kSlotHead + i);
    if (W == 2) local |= (uint64_t)__ldg(blk + kSlotHead + cap + i) << 32;
    atomicOr(ctx_words + (local >> 5), 1u << (local & 31));
  }
}

int64_t n_tiles(int64_t n_pos) { return (n_pos + kTile - 1) / kTile; }

}  // namespace

extern "C" {

int malva_window_hash(const void* seq, int64_t n_pos, int k, int ref_k, void* out,
                      void* stream) {
  if (n_pos <= 0) return 0;
  int grid = 0;
  const int e = persistent_grid(window_hash_kernel, kThreads, 0, n_tiles(n_pos), &grid);
  if (e != 0) return e;
  window_hash_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)seq, n_pos, k, ref_k, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// K8's first launch: the codes of n_pos positions (see above).
int malva_scan_codes(const void* seq, int64_t n_pos, int k, int ref_k, const void* bf_words,
                     int64_t size_bits, void* codes, void* stream) {
  if (n_pos <= 0) return 0;
  int grid = 0;
  const int e = persistent_grid(scan_codes_kernel, kThreads, 0, n_tiles(n_pos), &grid);
  if (e != 0) return e;
  scan_codes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)seq, n_pos, k, ref_k, (const uint32_t*)bf_words, (uint64_t)size_bits,
      (uint64_t*)codes);
  return (int)cudaGetLastError();
}

// K9 over n_blocks slot blocks of cap rows of W words (1 or 2) into
// ctx_words.  One launch.
int malva_scan_set(const void* slots, int n_blocks, int64_t cap, int W, void* ctx_words,
                   void* stream) {
  if (n_blocks < 1 || n_blocks > 65535 || cap < 1 || (W != 1 && W != 2))
    return (int)cudaErrorInvalidValue;
  const int64_t want = (cap + kSetThreads - 1) / kSetThreads;
  const dim3 grid((unsigned)(want < kSetBlocksX ? want : kSetBlocksX), (unsigned)n_blocks);
  if (W == 1)
    scan_set_kernel<1><<<grid, kSetThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)slots, cap, (uint32_t*)ctx_words);
  else
    scan_set_kernel<2><<<grid, kSetThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)slots, cap, (uint32_t*)ctx_words);
  return (int)cudaGetLastError();
}

int malva_ref_scan(const void* seq, int64_t n_pos, int k, int ref_k, const void* bf_words,
                   void* ctx_words, int64_t size_bits, void* stream) {
  if (n_pos <= 0) return 0;
  int grid = 0;
  const int e = persistent_grid(ref_scan_kernel, kThreads, 0, n_tiles(n_pos), &grid);
  if (e != 0) return e;
  ref_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)seq, n_pos, k, ref_k, (const uint32_t*)bf_words, (uint32_t*)ctx_words,
      (uint64_t)size_bits);
  return (int)cudaGetLastError();
}

}  // extern "C"
