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
// The pack mode is K8 (scan_pack, the sharded scan's entry), one launch:
// the scan's tile code, but where the scan sets a bit, the tile partitions
// its hits by the owner of their context word into the owners' slot
// blocks (the format of route.cu's K6 and K7, rows of W words:
// route.cuh ScanRows), in position order, as K6's tiles do:
//
// * Hits in position order, in shared memory.  Each warp's ballot of a
//   group of positions is a word of the tile's hit bitmap; the words'
//   prefix ranks each hit among the tile's (route.cuh hit_rank), and the
//   warp's queued hits write their columns (the shard-local bit index) and
//   owner at that rank.  No per-position code leaves the tile.
// * Ranks by owner: the tile's hits, 256 at a time, ranked within their
//   owner by the ballots of the owner's bits (as K6's lanes), the counts
//   of each warp summed in warp order.
// * Bases by decoupled look-back (partition.cuh, as K6 and K7): the tile
//   publishes its count per owner, and warp 0 looks back over the tiles
//   before it; then each row goes to its owner's block, or past cap to the
//   overflow list, whose place the tile takes by one atomic add.  The
//   last tile writes the headers and the tally.
// * Tiles by ticket.  The persistent grid's blocks take their tiles from a
//   ticket in the scratch, each the next before it hashes the one it
//   holds (so that the next tile's bytes land meanwhile).  A tile waits
//   only on tiles of lower tickets, all taken by blocks that are running,
//   and the lowest unfinished of them waits on none: no deadlock, whatever
//   else the card runs.  The block that finishes last resets the scratch.
//
// K9 (scan_set, below) sets the bits on the shard that owns them, from the
// slot blocks K8 wrote and the copies brought: one atomicOr a row, as the
// scan's own.  K8 is bound like the scan, by the alt-filter read per
// position (a 32-byte sector); the partition adds the rows' writes.  K9 is
// bound by one 32-byte sector a row; at the main path's hit counts its
// launch costs more than its work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"
#include "launch.cuh"
#include "partition.cuh"
#include "route.cuh"

using namespace malva;

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;                  // positions a thread takes per tile
constexpr int kGroup = 4;                      // positions hashed before their reads
constexpr int kTile = kThreads * kPerThread;   // positions per tile
// a tile's bytes with the halo, at most, and 16 bytes the readers may touch past them
constexpr int kBufWords = ((kTile + kMaxLen - 1 + 15) / 16 * 16 + 16) / 4;

enum Mode { kScan, kHashOnly, kPack };

static_assert(kTile == kTileLanes && kThreads == kRouteThreads,
              "K8's tiles are route.cuh's: a status a tile, a rank a thread of 256");

struct Tiles {
  uint32_t raw[2][kBufWords];  // the chunk's bytes, two tiles in turn
  uint32_t rev[kBufWords];     // the current tile's RCN-reversed copy
  int hits[kThreads / 32][32 * kPerThread];  // each warp's hit positions in the tile
  uint8_t rcn[256];
};

// K8's partition (pack mode): its kernel parameters...
struct PackArgs {
  Blocks out;                      // the owners' slot blocks
  int D;
  uint32_t wps;                    // context words a shard
  int64_t cap, ovf_cap;
  uint32_t* ovf;                   // [W planes | owner plane] of ovf_cap rows
  unsigned long long* tally;       // [rows spilled, rows sent to each owner]
  unsigned long long* scratch;     // [ticket, blocks done, a status per tile and owner]
};

// ... and a tile's hits in shared memory, in position order (nothing in
// the other modes, W = 0).
template <int W>
struct PackShared {
  uint32_t col[W][kTile];          // each hit's W columns (ScanRows::columns)
  uint32_t rk[kTile];              // its owner, then its rank among the owner's (dest_rank)
  uint32_t bm[kTile / 32];         // the tile's hit bitmap
  uint32_t pre[kTile / 32 + 1];    // its words' exclusive prefix, then the tile's hits
  TileShared ts;
  int64_t ticket;
  int last_done;
};

template <>
struct PackShared<0> {};

constexpr int kScanLook = 4;  // statuses a lane reads in a look-back step (one tile mostly)

// Pack mode, after the tile's hits are in place: their ranks by owner, the
// tile's counts published, the look-back for its bases, the rows written.
template <int W>
__device__ __forceinline__ void pack_tile(PackShared<W>& ps, int64_t t, int64_t last,
                                          const PackArgs& pk) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, D = pk.D, bits = dest_bits(D);
  const uint32_t n = ps.pre[kTile / 32], lt = (1u << lane) - 1u;
  unsigned long long* status = pk.scratch + kScratchHead;
  for (uint32_t c0 = 0; c0 < n; c0 += kThreads) {  // kThreads hits at a time, in order
    const uint32_t j = c0 + tid;
    const int d = j < n ? (int)ps.rk[j] : D;
    uint32_t ballot[kDestBits];
    const uint32_t valid = __ballot_sync(~0u, d < D);
#pragma unroll
    for (int b = 0; b < kDestBits; ++b) ballot[b] = b < bits ? __ballot_sync(~0u, d >> b & 1) : 0u;
    const uint32_t below = __popc(dest_mask(valid, ballot, bits, d) & lt);
    if (lane < kMaxDests)
      ps.ts.woff[warp][lane] = lane < D ? __popc(dest_mask(valid, ballot, bits, lane)) : 0u;
    __syncthreads();
    if (tid < D) {  // owner tid's warp counts, exclusive in warp order, past the earlier hits
      uint32_t run = ps.ts.run[tid].tot;
#pragma unroll
      for (int w = 0; w < kRouteWarps; ++w) {
        const uint32_t c = ps.ts.woff[w][tid];
        ps.ts.woff[w][tid] = run;
        run += c;
      }
      ps.ts.run[tid].tot = run;
    }
    __syncthreads();
    if (d < D) ps.rk[j] = dest_rank(d, ps.ts.woff[warp][d] + below);
    __syncthreads();  // the offsets are read before the next hits' counts
  }
  if (warp == 0) {
    if (lane < D)
      publish(status + t * D + lane,
              status_word(t == 0 ? kStatusPrefix : kStatusAggregate, ps.ts.run[lane].tot));
    __syncwarp();
    tile_bases<kScanLook>(ps.ts, t, last, D, pk.out, pk.cap, pk.tally, 1, status);
  }
  __syncthreads();
  for (uint32_t j = tid; j < n; j += kThreads) {  // each row to its place
    const uint32_t v = ps.rk[j];
    const int d = (int)(v & ((1u << kRankShift) - 1u));
    if (d >= D) continue;
    uint32_t col[W + 1];
#pragma unroll
    for (int c = 0; c < W; ++c) col[c] = ps.col[c][j];
    col[W] = (uint32_t)d;
    place_row<W>(ps.ts.run[d], v >> kRankShift, col, pk.out.at(d) + kSlotHead, pk.cap, pk.ovf,
                 pk.ovf_cap);
  }
}

template <Mode kMode, int W = 0>
__device__ void scan_tiles(const uint8_t* __restrict__ seq, int64_t n_pos, int k, int ref_k,
                           const uint32_t* __restrict__ bf_words, uint32_t* __restrict__ ctx_words,
                           uint64_t size_bits, uint32_t* __restrict__ out, const PackArgs& pk) {
  __shared__ __align__(16) Tiles sm;
  __shared__ __align__(16) PackShared<kMode == kPack ? W : 0> ps;
  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += kThreads) sm.rcn[i] = rcn((uint8_t)i);

  // pack mode: every tile publishes its counts, a launch of no position too
  const int64_t n_bytes = n_pos > 0 ? n_pos + ref_k - 1 : 0;
  const int64_t n_tiles = kMode == kPack ? last_tile(n_pos) + 1 : (n_pos + kTile - 1) / kTile;
  const int want = kTile + ref_k - 1, off = (ref_k - k) / 2;
  const bool aligned = (reinterpret_cast<uintptr_t>(seq) & 15) == 0;
  auto raw = [&](int b) { return reinterpret_cast<uint8_t*>(sm.raw[b]); };
  auto tile_bytes = [&](int64_t tile) {
    const int64_t left = n_bytes - tile * kTile;
    return left < want ? (int)left : want;
  };

  int64_t tile = blockIdx.x;
  if constexpr (kMode == kPack) {
    if (tid == 0) ps.ticket = (int64_t)atomicAdd(pk.scratch, 1ull);
    __syncthreads();
    tile = ps.ticket;
  }
  if (tile < n_tiles) copy_async(raw(0), seq + tile * kTile, tile_bytes(tile), aligned);
  for (int buf = 0; tile < n_tiles; buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // the tile has landed; the previous tile's readers are done
    if constexpr (kMode == kPack)
      if (tid == 0) ps.ticket = (int64_t)atomicAdd(pk.scratch, 1ull);  // the next tile
    const uint32_t* fwd = sm.raw[buf];
    const int E = (tile_bytes(tile) + 3) & ~3;
    for (int q = tid; q < E / 4; q += kThreads) sm.rev[q] = rcn_reverse4(fwd[E / 4 - 1 - q], sm.rcn);
    __syncthreads();
    int64_t next = tile + gridDim.x;
    if constexpr (kMode == kPack) next = ps.ticket;
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
          if constexpr (kMode == kPack)  // positions (g + r) * kThreads + the warp's 32
            if ((tid & 31) == 0) ps.bm[(g + r) * (kThreads / 32) + (tid >> 5)] = go;
          n_hits += __popc(go);
        }
#pragma unroll
        for (int r = 0; r < kGroup; ++r) c[r] = cn[r];
      }
      if constexpr (kMode == kPack) {
        // the tile's hits in position order: the bitmap words' prefix
        // (warp 0), then the warp's hits, every lane busy: the window's
        // hash, its owner and columns at the hit's rank
        __syncthreads();
        if (tid < 32) {
          const uint32_t a = __popc(ps.bm[2 * tid]), b = __popc(ps.bm[2 * tid + 1]);
          uint32_t incl = a + b;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const uint32_t v = __shfl_up_sync(~0u, incl, o);
            if (tid >= o) incl += v;
          }
          ps.pre[2 * tid] = incl - a - b;
          ps.pre[2 * tid + 1] = incl - b;
          if (tid == 31) ps.pre[kTile / 32] = incl;
          if (tid < kMaxDests) ps.ts.run[tid].tot = 0;
        }
        __syncthreads();
        const ScanRows<W> rows{pk.wps};
#pragma unroll 1
        for (int e = tid & 31; e < n_hits; e += 32) {
          const uint64_t cidx =
              bloom_index(window_hash_at(fwd, sm.rev, E, hits[e], ref_k), size_bits);
          const uint32_t lo = (uint32_t)cidx, hi = (uint32_t)(cidx >> 32);
          const uint32_t at = hit_rank(ps.bm, ps.pre, hits[e]);
          const int d = rows.dest(lo, hi, pk.D);
          uint32_t col[W + 1];
          rows.columns(lo, hi, d, col);
#pragma unroll
          for (int q = 0; q < W; ++q) ps.col[q][at] = col[q];
          ps.rk[at] = (uint32_t)d;
        }
        __syncthreads();
        pack_tile<W>(ps, tile, n_tiles - 1, pk);
      } else {
        // the warp's hits, every lane busy: the window's hash, one bit set
        __syncwarp();
#pragma unroll 1
        for (int e = tid & 31; e < n_hits; e += 32) {
          const uint64_t cidx =
              bloom_index(window_hash_at(fwd, sm.rev, E, hits[e], ref_k), size_bits);
          atomicOr(ctx_words + (cidx >> 5), 1u << (cidx & 31));
        }
      }
    }
    tile = next;
  }

  if constexpr (kMode == kPack) {
    // the block that finishes last resets the scratch: every look-back is
    // over, and no block takes another ticket
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      ps.last_done = atomicAdd(pk.scratch + 1, 1ull) == (unsigned long long)(gridDim.x - 1);
    }
    __syncthreads();
    if (ps.last_done) {
      unsigned long long* status = pk.scratch + kScratchHead;
      for (int64_t q = tid; q < n_tiles * pk.D; q += kThreads) status[q] = 0;
      if (tid == 0) pk.scratch[0] = pk.scratch[1] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    window_hash_kernel(const uint8_t* __restrict__ seq, int64_t n_pos, int k, int ref_k,
                       uint32_t* __restrict__ out) {
  scan_tiles<kHashOnly>(seq, n_pos, k, ref_k, nullptr, nullptr, 0, out, PackArgs{});
}

__global__ void __launch_bounds__(kThreads)
    ref_scan_kernel(const uint8_t* __restrict__ seq, int64_t n_pos, int k, int ref_k,
                    const uint32_t* __restrict__ bf_words, uint32_t* __restrict__ ctx_words,
                    uint64_t size_bits) {
  scan_tiles<kScan>(seq, n_pos, k, ref_k, bf_words, ctx_words, size_bits, nullptr, PackArgs{});
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    scan_pack_kernel(const uint8_t* __restrict__ seq, int64_t n_pos, int k, int ref_k,
                     const uint32_t* __restrict__ bf_words, uint64_t size_bits, PackArgs pk) {
  scan_tiles<kPack, W>(seq, n_pos, k, ref_k, bf_words, nullptr, size_bits, nullptr, pk);
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

// K8 (scan_pack), the sharded context scan's entry, over n_pos positions
// of a shard's slice of the contig (`seq`, n_pos + ref_k - 1 bytes with the
// halo): each hit goes into blocks[d] of its owner d (cap rows of W words
// each: the shard-local bit index), in position order, or to the overflow
// list ([W planes | owner plane] of ovf_cap rows); the tally gets the rows
// spilled at [0] and the rows sent to d at [1 + d].  `scratch`:
// malva_route_scratch_words(D) words (route.cu), zeroed when made, left
// zeroed.  One kernel launch.
int malva_scan_pack(const void* seq, int64_t n_pos, int k, int ref_k, const void* bf_words,
                    int64_t size_bits, int64_t wps, int W, int D, void* const* blocks, int64_t cap,
                    void* ovf, int64_t ovf_cap, void* tally, void* scratch, void* stream) {
  if (wps < 1 || wps > UINT32_MAX || n_pos < 0 || (W != 1 && W != 2) ||
      (W == 1 && wps > (int64_t)1 << 27) || D < 1 || D > kMaxDests || cap < 1 ||
      last_tile(n_pos) + 1 > kMaxTiles)
    return (int)cudaErrorInvalidValue;
  PackArgs pk{};
  for (int d = 0; d < D; ++d) pk.out.p[d] = (uint32_t*)blocks[d];
  pk.D = D;
  pk.wps = (uint32_t)wps;
  pk.cap = cap;
  pk.ovf_cap = ovf_cap;
  pk.ovf = (uint32_t*)ovf;
  pk.tally = (unsigned long long*)tally;
  pk.scratch = (unsigned long long*)scratch;
  auto go = [&](auto kernel) {
    int grid = 0;
    const int e = persistent_grid(kernel, kThreads, 0, last_tile(n_pos) + 1, &grid);
    if (e != 0) return e;
    kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const uint8_t*)seq, n_pos, k, ref_k,
                                                        (const uint32_t*)bf_words,
                                                        (uint64_t)size_bits, pk);
    return (int)cudaGetLastError();
  };
  return W == 1 ? go(scan_pack_kernel<1>) : go(scan_pack_kernel<2>);
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
