// K1: the call-phase query/update step over packed sample contexts.
//
// Replaces malva_tpu/ops/pallas_kernels.py:125 make_callstep_hash_fn (the
// front end) together with the XLA rest of index/device.py:400
// make_call_step_packed.  Per lane: canonical centred k-mer in 2-bit
// space, its XXH3, the Bloom index, one 8-byte gather of the (W, 2)
// word+rank row, and the mini-filter test.  Only a lane that hits the alt
// filter or is an exact-map candidate goes on: the context XXH3 and the
// context-filter test, an atomicAdd into the rank-compressed counters,
// and the two-bucket probe with an atomicAdd into the exact-map values.
// uint32 adds commute, so the final state does not depend on thread order
// and is bit-exact with the plain step (ops/kernels.py).
//
// Bound: bytes.  Per lane the kernel must read its packed context and
// counter (16 B at ref_k 43) and one random 8-byte row of a GiB-sized
// array, whose 32-byte sector is the real cost; the hashing is a few
// hundred integer instructions (chip_smoke.py counts both: 0.0178 ms per
// 2^21 lanes, bytes).  The card serves such random reads far below its
// byte rate, so the practical floor is the gathers themselves (chip_smoke.py
// times torch's gather of the same rows beside the kernel, `gather_ms`),
// plus the tails' own random reads and atomics.  This design keeps the
// SMs' work out of their way:
//
// * Registers only.  The context's word count N = ceil(ref_k / 16) is a
//   template parameter (instantiated for 1..15); the canonical centre is
//   taken in 2-bit space (lanes.cuh canonical_centre: bit reversal, pair
//   swap, complement, shifts by unrolled selects), and XXH3 reads the
//   ASCII of the bases straight from those registers (PackedBases: a
//   funnel shift of two words, then word arithmetic).
// * Coalesced contexts.  A warp stages the contexts and counters of its
//   32 x kLanes lanes in one of its two slices of shared memory with
//   16-byte cp.async copies, and each lane then reads its own N words
//   from there.
// * More gathers in flight.  A persistent grid; each warp walks its tiles
//   of 32 x kLanes lanes in a software pipeline: the kLanes row gathers of
//   a thread's lanes in tile t are issued together and stay in flight
//   while the warp runs a pass of queued tails and hashes the next tile,
//   whose copy into the other slice was started just before them, so that
//   it does not queue behind them.
// * One copy of each piece of code.  The loops over a thread's lanes are
//   not unrolled (the results go to registers by unrolled selects, put
//   and pick), so the hashing code is there once.
// * The rare tails batched.  The lanes that hit the alt filter or are
//   exact-map candidates (a few percent) are queued, with their context
//   and counter from the tile's slice, in a ring in shared memory for the
//   whole warp.  Once 32 are queued the warp runs them (the context hash
//   and filter read, the probe, the atomics) in one pass with every lane
//   busy, under a tile's gathers; what is left runs after the last tile.
//   Each pass is one round of dependent reads, where running a tile's few
//   tails at once costs a round per tile with most lanes idle, and no
//   queued lane reads its context again from device memory.
// * Small tiles, many warps.  Blocks of 128 threads, two lanes a thread
//   in a pass (one past ref_k 128), and the call step at six blocks an SM
//   up to ref_k 64 (at most 80 registers a thread): the random reads
//   leave the SMs mostly waiting, so what counts is many warps with reads
//   in flight and little work left over at the end.  ptxas reports no
//   stack frame and no spill in any instantiation (chip_smoke.py checks).
//
// The TPU's lane compaction (segmented sort, tiered tails, lax.cond tree)
// becomes the warp's tail queue; a lane with a zero counter (padding)
// does nothing.
//
// Both launchers take an optional pair of CUDA events and record them just
// before and after the launch, inside the same C call (launch.cuh), so the
// time between them is the kernel's device time even while other Python
// threads hold the GIL.
#include <cuda_runtime.h>

#include "lanes.cuh"
#include "launch.cuh"

using namespace malva;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <int N>
struct Shape {
  static constexpr int kLanes = N <= 8 ? 2 : 1;   // lanes per thread per pass
  static constexpr int kTileLanes = 32 * kLanes;  // lanes per warp per pass
  static constexpr int kTileWords = kTileLanes * N;
  // blocks an SM for the call step: six (at most 80 registers a thread)
  // up to ref_k 64, and no bound for longer contexts, so that nothing spills
  static constexpr int kMinBlocks = N <= 4 ? 6 : 1;
};

// Starts the copy of the contexts (and, where `counters` is given, the
// counters) of a warp's lanes first .. first + kTileLanes - 1 into its
// slices: 16-byte cp.async copies where the tile is whole and aligned,
// words otherwise.  staged_wait() waits for them.
template <int N>
__device__ void stage_tile(uint32_t* dst, uint32_t* cnt, const uint32_t* __restrict__ ctx,
                           const uint32_t* __restrict__ counters, int64_t first, int64_t B,
                           int lane) {
  constexpr int W = Shape<N>::kTileWords, C = Shape<N>::kTileLanes;
  const uint32_t* src = ctx + first * N;
  const uint32_t* csrc = counters ? counters + first : src;
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(csrc)) & 15) == 0;
  __syncwarp();  // the warp is done with the slices
  if (first + C <= B && aligned) {
    for (int q = lane; q < W / 4; q += 32) cp_async16(dst + 4 * q, src + 4 * q);
    if (counters)
      for (int q = lane; q < C / 4; q += 32) cp_async16(cnt + 4 * q, csrc + 4 * q);
  } else {
    const int64_t avail = (B - first) * N;
    for (int q = lane; q < W && q < avail; q += 32) dst[q] = __ldg(src + q);
    if (counters)
      for (int q = lane; q < C; q += 32) cnt[q] = first + q < B ? __ldg(csrc + q) : 0u;
  }
  cp_async_commit();
}

__device__ __forceinline__ void staged_wait() {
  cp_async_wait_all();
  __syncwarp();
}

template <int N>
__device__ __forceinline__ void staged_context(const uint32_t* tile, int slot, uint32_t (&w)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) w[j] = tile[slot * N + j];
}

// Hash-only mode: exactly the TPU kernel's outputs, one plane of B words
// each: [ctx_hi, ctx_lo,] c_hi, c_lo, can_0 .. can_{w_k-1}.
template <int N>
__global__ void __launch_bounds__(kThreads, 4)
    callstep_hash_kernel(const uint32_t* __restrict__ ctx, int64_t B, int k, int ref_k,
                         int with_ctx, uint32_t* __restrict__ out) {
  using S = Shape<N>;
  __shared__ __align__(16) uint32_t tiles[kWarps][S::kTileWords];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* tile = tiles[warp];
  const int64_t n_tiles = (B + S::kTileLanes - 1) / S::kTileLanes;
  const int w_k = (k + 15) / 16;
  for (int64_t t = (int64_t)blockIdx.x * kWarps + warp; t < n_tiles;
       t += (int64_t)gridDim.x * kWarps) {
    const int64_t first = t * S::kTileLanes;
    stage_tile<N>(tile, nullptr, ctx, nullptr, first, B, lane);
    staged_wait();
#pragma unroll 1
    for (int r = 0; r < S::kLanes; ++r) {
      const int64_t i = first + r * 32 + lane;
      if (i >= B) continue;
      uint32_t w[N], can[N];
      staged_context(tile, r * 32 + lane, w);
      int at = 0;
      if (with_ctx) {
        const uint64_t x = xxh3_64(PackedBases<N>(w), ref_k);
        out[i] = (uint32_t)(x >> 32);
        out[B + i] = (uint32_t)x;
        at = 2;
      }
      const uint64_t c = centre_hash(w, k, ref_k, can);
      out[at * B + i] = (uint32_t)(c >> 32);
      out[(at + 1) * B + i] = (uint32_t)c;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < w_k) out[(at + 2 + j) * B + i] = can[j];
    }
  }
}

// The front half of a pass over a staged warp tile: for each of this
// thread's kLanes lanes with a non-zero counter (bit r of the result) its
// centre hash into c[r].  The loop is not unrolled, so the hashing code is
// there once; put() keeps c in registers.
template <int N>
__device__ __forceinline__ uint32_t centre_hashes(const uint32_t* tile, const uint32_t* cnt,
                                                  int k, int ref_k, int lane,
                                                  uint64_t (&c)[Shape<N>::kLanes]) {
  staged_wait();
  uint32_t live = 0;
#pragma unroll
  for (int r = 0; r < Shape<N>::kLanes; ++r)
    live |= (uint32_t)(cnt[r * 32 + lane] != 0) << r;  // 0 adds nothing anywhere
#pragma unroll 1
  for (int r = 0; r < Shape<N>::kLanes; ++r) {
    if (!((live >> r) & 1u)) continue;
    uint32_t w[N], can[N];
    staged_context(tile, r * 32 + lane, w);
    put(c, r, centre_hash(w, k, ref_k, can));
  }
  return live;
}

// A warp's tails: the lanes that go on past the row test, queued in a
// ring of kRing entries in shared memory, one array per field, so that
// the 32 lanes of a pass read distinct banks.  An entry holds what the
// tail needs: the context, the counter, the centre hash, the counter
// index (used when the Bloom bit is set) and what (bit 0: the Bloom bit
// is set; bit 1: an exact-map candidate).
template <int N>
struct TailRing {
  static constexpr int kRing = 2 * Shape<N>::kTileLanes;  // a power of two
  uint32_t ctx[N][kRing];
  uint32_t cnt[kRing], h_hi[kRing], h_lo[kRing], cidx[kRing], what[kRing];
};

// One pass over the n (<= 32) ring entries from `head` on, one a lane:
// the context hash and the context-filter read, and the canonical centre
// and its two-bucket probe, each read issued before any is used; then the
// atomics.
template <int N>
__device__ __forceinline__ void run_tails(const TailRing<N>& q, uint32_t head, int n, int lane,
                                          int k, int ref_k,
                                          const uint32_t* __restrict__ ctx_words,
                                          const uint32_t* __restrict__ kmap_keys,
                                          uint32_t* __restrict__ state, int64_t counts_len,
                                          uint64_t n_buckets, uint64_t size_bits) {
  __syncwarp();  // the entries were written by other lanes
  if (lane >= n) return;
  const uint32_t e = (head + lane) & (TailRing<N>::kRing - 1);
  uint32_t w[N];
#pragma unroll
  for (int j = 0; j < N; ++j) w[j] = q.ctx[j][e];
  const uint32_t what = q.what[e], cnt = q.cnt[e];
  uint64_t x = 0;
  uint32_t word = ~0u;
  if (what & 1u) {
    x = bloom_index(xxh3_64(PackedBases<N>(w), ref_k), size_bits);
    word = __ldg(ctx_words + (x >> 5));
  }
  int64_t slot = -1;
  if (what & 2u) {
    uint32_t can[N];
    canonical_centre(w, k, ref_k, can);
    slot = probe_buckets(kmap_keys, n_buckets, (k + 15) / 16, can,
                         (uint64_t)q.h_hi[e] << 32 | q.h_lo[e]);
  }
  if (!((word >> (x & 31)) & 1u)) atomicAdd(state + q.cidx[e], cnt);
  if (slot >= 0) atomicAdd(state + counts_len + slot, cnt);
}

template <int N>
__global__ void __launch_bounds__(kThreads, Shape<N>::kMinBlocks)
    callstep_kernel(const uint32_t* __restrict__ ctx, const uint32_t* __restrict__ counters,
                    int64_t B, int k, int ref_k, const uint2* __restrict__ bf_packed,
                    const uint32_t* __restrict__ ctx_words, const uint32_t* __restrict__ kmap_keys,
                    uint32_t* __restrict__ state, int64_t counts_len, uint64_t n_buckets,
                    uint64_t size_bits, int minifilter) {
  using S = Shape<N>;
  constexpr int L = S::kLanes, kRing = TailRing<N>::kRing;
  __shared__ __align__(16) uint32_t tiles[kWarps][2][S::kTileWords];
  __shared__ __align__(16) uint32_t cnts[kWarps][2][S::kTileLanes];
  __shared__ TailRing<N> rings[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  TailRing<N>& ring = rings[warp];
  const int64_t n_tiles = (B + S::kTileLanes - 1) / S::kTileLanes;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  const bool use_mf = minifilter && n_buckets > 1;
  auto tails = [&](uint32_t head, int n) {
    run_tails<N>(ring, head, n, lane, k, ref_k, ctx_words, kmap_keys, state, counts_len,
                 n_buckets, size_bits);
  };

  // A software pipeline over this warp's tiles, each staged in one of two
  // slices in turn.  In each turn the next tile's copy starts first, then
  // tile t's row gathers are issued; while they are in flight the warp
  // runs a full pass of queued tails, if there is one, and hashes the next
  // tile; then it queues tile t's lanes that go on, from its slice.  So
  // the tails' dependent reads and atomics overlap the gathers too, and a
  // pass of them has every lane busy.
  int64_t t = (int64_t)blockIdx.x * kWarps + warp;
  int b = 0;  // the slice of tile t
  uint64_t c[L] = {};
  uint32_t live = 0, head = 0, n_queued = 0;
  if (t < n_tiles) {
    stage_tile<N>(tiles[warp][0], cnts[warp][0], ctx, counters, t * S::kTileLanes, B, lane);
    live = centre_hashes<N>(tiles[warp][0], cnts[warp][0], k, ref_k, lane, c);
  }
  for (; t < n_tiles; b ^= 1) {
    const int64_t next = t + stride;
    if (next < n_tiles)
      stage_tile<N>(tiles[warp][b ^ 1], cnts[warp][b ^ 1], ctx, counters,
                    next * S::kTileLanes, B, lane);
    uint2 row[L];
#pragma unroll
    for (int r = 0; r < L; ++r)
      row[r] = (live >> r) & 1u ? __ldg(bf_packed + (bloom_index(c[r], size_bits) >> 5))
                                : make_uint2(0, 0);

    for (; n_queued >= 32; head += 32, n_queued -= 32) tails(head, 32);

    uint64_t cn[L] = {};
    const uint32_t live_next =
        next < n_tiles ? centre_hashes<N>(tiles[warp][b ^ 1], cnts[warp][b ^ 1], k, ref_k,
                                          lane, cn)
                       : 0;

    // Queue tile t's lanes that go on.  Fewer than 32 entries were left
    // above, so the ring (2 kTileLanes >= 32 + kTileLanes) holds this
    // tile's kTileLanes more.
    __syncwarp();  // the pass above has read its entries
    const uint32_t* tile = tiles[warp][b];
    const uint32_t* tile_cnt = cnts[warp][b];
#pragma unroll
    for (int r = 0; r < L; ++r) {
      const uint32_t bit = (uint32_t)(bloom_index(c[r], size_bits) & 31);
      const bool is_set = (row[r].x >> bit) & 1u;
      const bool cand = !use_mf || (((row[r].y >> kRankBits) >> (uint32_t)((c[r] >> 60) & 3)) & 1u);
      const uint32_t what = ((live >> r) & 1u) * ((uint32_t)is_set | (uint32_t)cand << 1);
      const unsigned go = __ballot_sync(0xFFFFFFFFu, what != 0);
      if (what) {
        const uint32_t e = (head + n_queued + __popc(go & ((1u << lane) - 1u))) & (kRing - 1);
        const int slot = r * 32 + lane;
#pragma unroll
        for (int j = 0; j < N; ++j) ring.ctx[j][e] = tile[slot * N + j];
        const uint32_t rank = minifilter ? (row[r].y & kRankMask) : row[r].y;
        ring.cnt[e] = tile_cnt[slot];
        ring.h_hi[e] = (uint32_t)(c[r] >> 32);
        ring.h_lo[e] = (uint32_t)c[r];
        ring.cidx[e] = rank + popc32(row[r].x & ((1u << bit) - 1u));
        ring.what[e] = what;
      }
      n_queued += __popc(go);
    }
#pragma unroll
    for (int r = 0; r < L; ++r) c[r] = cn[r];
    live = live_next;
    t = next;
  }
  // what is left, in passes of 32
  for (; n_queued > 0; head += 32) {
    const int n = n_queued < 32 ? (int)n_queued : 32;
    tails(head, n);
    n_queued -= n;
  }
}

template <int N>
int launch_hash(const uint32_t* ctx, int64_t B, int k, int ref_k, int with_ctx, uint32_t* out,
                void* ev_start, void* ev_stop, cudaStream_t stream) {
  int grid = 0;
  const int64_t blocks = (B + Shape<N>::kTileLanes * kWarps - 1) / (Shape<N>::kTileLanes * kWarps);
  const int e = persistent_grid(callstep_hash_kernel<N>, kThreads, 0, blocks, &grid);
  if (e != 0) return e;
  return launch_timed(ev_start, ev_stop, stream, [&](cudaStream_t s) {
    callstep_hash_kernel<N><<<grid, kThreads, 0, s>>>(ctx, B, k, ref_k, with_ctx, out);
  });
}

template <int N>
int launch_step(const uint32_t* ctx, const uint32_t* counters, int64_t B, int k, int ref_k,
                const uint2* bf_packed, const uint32_t* ctx_words, const uint32_t* kmap_keys,
                uint32_t* state, int64_t counts_len, uint64_t n_buckets, uint64_t size_bits,
                int minifilter, void* ev_start, void* ev_stop, cudaStream_t stream) {
  int grid = 0;
  const int64_t blocks = (B + Shape<N>::kTileLanes * kWarps - 1) / (Shape<N>::kTileLanes * kWarps);
  const int e = persistent_grid(callstep_kernel<N>, kThreads, 0, blocks, &grid);
  if (e != 0) return e;
  return launch_timed(ev_start, ev_stop, stream, [&](cudaStream_t s) {
    callstep_kernel<N><<<grid, kThreads, 0, s>>>(ctx, counters, B, k, ref_k, bf_packed, ctx_words,
                                                kmap_keys, state, counts_len, n_buckets, size_bits,
                                                minifilter);
  });
}

}  // namespace

#define MALVA_WORD_COUNTS(F) \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12) F(13) F(14) F(15)

extern "C" {

int malva_callstep_hash(const void* ctx, int64_t B, int wc, int k, int ref_k, int with_ctx,
                        void* out, void* ev_start, void* ev_stop, void* stream) {
  if (B <= 0) return launch_timed(ev_start, ev_stop, (cudaStream_t)stream, [](cudaStream_t) {});
  switch (wc) {
#define MALVA_K1_HASH(n)                                                                   \
  case n:                                                                                  \
    return launch_hash<n>((const uint32_t*)ctx, B, k, ref_k, with_ctx, (uint32_t*)out,     \
                          ev_start, ev_stop, (cudaStream_t)stream);
    MALVA_WORD_COUNTS(MALVA_K1_HASH)
#undef MALVA_K1_HASH
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int malva_callstep(const void* ctx, const void* counters, int64_t B, int wc, int k, int ref_k,
                   const void* bf_packed, const void* ctx_words, const void* kmap_keys,
                   void* state, int64_t counts_len, int64_t n_buckets, int64_t size_bits,
                   int minifilter, void* ev_start, void* ev_stop, void* stream) {
  if (B <= 0) return launch_timed(ev_start, ev_stop, (cudaStream_t)stream, [](cudaStream_t) {});
  switch (wc) {
#define MALVA_K1_STEP(n)                                                                     \
  case n:                                                                                    \
    return launch_step<n>((const uint32_t*)ctx, (const uint32_t*)counters, B, k, ref_k,      \
                          (const uint2*)bf_packed, (const uint32_t*)ctx_words,               \
                          (const uint32_t*)kmap_keys, (uint32_t*)state, counts_len,          \
                          (uint64_t)n_buckets, (uint64_t)size_bits, minifilter, ev_start,    \
                          ev_stop, (cudaStream_t)stream);
    MALVA_WORD_COUNTS(MALVA_K1_STEP)
#undef MALVA_K1_STEP
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
