// The call-step kernel family: K1 (callstep.cu, the one-device step) and
// K4 (shard_step.cu, the owner side of the routed sharded step, with its
// slot entry) are one template, step_body<N, Policy>, that differ only in
// their policy.  (K5, the all-gather step's shard side, was a third policy
// until its lanes came pre-hashed: shard_step.cu, gather.cuh.)
//
// Per lane: the canonical centre of the packed context and its XXH3, in
// registers (lanes.cuh centre_hash); the gather of its 8-byte [word, rank
// | mini-filter << 28] row; the row test (lanes.cuh row_test).  A lane
// whose Bloom bit is set or that is an exact-map candidate goes on to a
// tail: when its Bloom bit is set and its context is not known, an
// atomicAdd of its counter into the rank-compressed counters; when it is
// a candidate, the two-bucket probe of the exact map and an atomicAdd into
// the slot's value.  uint32 adds commute, so the final state does not
// depend on thread order and is bit-exact with the plain versions
// (ops/kernels.py).
//
// A policy says what the steps do differently:
//   * stage(...): how a warp's tile of lanes is copied into shared memory
//     (K1, K4: rows of contiguous context and counter arrays,
//     ContiguousLanes; K4's slot entry: the live rows of the hop-2 slot
//     blocks, block after block, with their "context known" flags,
//     shard_step.cu);
//   * owns(idx): whether the lane of Bloom index idx has anything to do in
//     this launch, its row being in the rows it holds (K1: every word; K4:
//     the shard's range, other lanes are no-ops);
//   * row(idx): the row of Bloom index idx (K4: less the shard's first
//     word);
//   * kCarry: what the tail ring carries for a lane beside its context,
//     counter and hashes (K1: nothing; K4: its index in the launch; K4's
//     slot entry: its staged flag);
//   * context_word(w, carried, ...): in the tail, the word whose bit `bit`
//     says that the lane's context is known (K1: the context filter's word
//     at the XXH3 of the whole context; K4: the flag that the step found
//     before the launch, read from the `known` array at the lane's index;
//     K4's slot entry: the flag itself, with no read).
//
// The design (the numbers are chip_smoke.py's, per 2^21 lanes):
//
// * Registers only.  The context's word count N = ceil(ref_k / 16) is a
//   template parameter (instantiated for 1..15); the canonical centre is
//   taken in 2-bit space and XXH3 reads the ASCII of the bases straight
//   from those registers (lanes.cuh PackedBases).
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
// * The rare tails batched.  The lanes that go on (a few percent where the
//   rows carry the exact map's mini-filter) are queued, with their context
//   and counter from the tile's slice, in a ring in shared memory for the
//   whole warp.  Once 32 are queued the warp runs them (the context test,
//   the probe, the atomics) in one pass with every lane busy, under a
//   tile's gathers; what is left runs after the last tile.  Each pass is
//   one round of dependent reads, and no queued lane reads its context
//   again from device memory.
// * Small tiles, many warps.  Blocks of 128 threads, two lanes a thread
//   in a pass (one past ref_k 128), and six blocks an SM up to ref_k 64
//   (at most 80 registers a thread): the random reads leave the SMs mostly
//   waiting, so what counts is many warps with reads in flight and little
//   work left over at the end.  ptxas reports no stack frame and no spill
//   in any instantiation (chip_smoke.py checks).
//
// The TPU's lane compaction (segmented sort, tiered tails, lax.cond tree)
// becomes the warp's tail queue; a lane with a zero counter (padding)
// does nothing.
#pragma once

#include <cuda_runtime.h>

#include "lanes.cuh"
#include "launch.cuh"

namespace malva {

constexpr int kStepThreads = 128;
constexpr int kStepWarps = kStepThreads / 32;

template <int N>
struct Shape {
  static constexpr int kLanes = N <= 8 ? 2 : 1;   // lanes per thread per pass
  static constexpr int kTileLanes = 32 * kLanes;  // lanes per warp per pass
  static constexpr int kTileWords = kTileLanes * N;
  // blocks an SM for the step: six (at most 80 registers a thread) up to
  // ref_k 64, and no bound for longer contexts, so that nothing spills
  static constexpr int kMinBlocks = N <= 4 ? 6 : 1;
};

// What a tail ring entry carries for its lane (a policy's kCarry).
enum class Carry { kNothing, kLaneIndex, kStagedFlag };

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

// Starts the copy of n words from device memory to shared memory by a
// warp, thread `lane` of it: 16-byte cp.async copies where the two share
// their alignment mod 16 bytes (single words up to the boundary and past
// the last whole quad), single words throughout where they do not.
__device__ __forceinline__ void stage_run(uint32_t* dst, const uint32_t* __restrict__ src, int n,
                                          int lane) {
  int head = n, quads = 0;
  if (((reinterpret_cast<uintptr_t>(dst) ^ reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    head = (int)(-(reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    head = head < n ? head : n;
    quads = (n - head) >> 2;
  }
  for (int q = lane; q < head; q += 32) cp_async4(dst + q, src + q);
  for (int q = lane; q < quads; q += 32) cp_async16(dst + head + 4 * q, src + head + 4 * q);
  for (int q = head + 4 * quads + lane; q < n; q += 32) cp_async4(dst + q, src + q);
}

__device__ __forceinline__ void staged_wait() {
  cp_async_wait_all();
  __syncwarp();
}

// The staging of K1 and K4: lane i's context and counter are row i of
// contiguous arrays.
struct ContiguousLanes {
  template <int N>
  __device__ __forceinline__ void stage(uint32_t* dst, uint32_t* cnt, uint32_t*,
                                        const uint32_t* ctx, const uint32_t* counters,
                                        int64_t first, int64_t B, int lane) const {
    stage_tile<N>(dst, cnt, ctx, counters, first, B, lane);
  }
};

template <int N>
__device__ __forceinline__ void staged_context(const uint32_t* tile, int slot, uint32_t (&w)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) w[j] = tile[slot * N + j];
}

// The front half of a pass over a staged warp tile: for each of this
// thread's kLanes lanes with a non-zero counter that is live in the launch
// (bit r of the result) its centre hash into c[r].  The loop
// is not unrolled, so the hashing code is there once; put() keeps c in
// registers.
template <int N, class P>
__device__ __forceinline__ uint32_t centre_hashes(const P& p, const uint32_t* tile,
                                                  const uint32_t* cnt, int k, int ref_k,
                                                  uint64_t size_bits, int lane,
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
    const uint64_t h = centre_hash(w, k, ref_k, can);
    put(c, r, h);
    if (!p.owns(bloom_index(h, size_bits))) live &= ~(1u << r);
  }
  return live;
}

// A warp's tails: the lanes that go on past the row test, queued in a
// ring of kRing entries in shared memory, one array per field, so that
// the 32 lanes of a pass read distinct banks.  An entry holds what the
// tail needs: the context, the counter, the centre hash, the counter
// index (used when the Bloom bit is set), `what` (row_test's) and what
// the policy carries (kCarry): a lane index in a word of its own, a staged
// flag in bit 2 of `what` (the ring's shared memory stays as K1's).
template <int N, Carry kCarry>
struct TailRing {
  static constexpr int kRing = 2 * Shape<N>::kTileLanes;  // a power of two
  static constexpr bool kCarries = kCarry == Carry::kLaneIndex;
  uint32_t ctx[N][kRing];
  uint32_t cnt[kRing], h_hi[kRing], h_lo[kRing], cidx[kRing], what[kRing];
  uint32_t carried[kCarries ? kRing : 1];
};

// One pass over the n (<= 32) ring entries from `head` on, one a lane:
// the context test's read, and the canonical centre and its two-bucket
// probe, each read issued before any is used; then the atomics.
template <int N, class P>
__device__ __forceinline__ void run_tails(const P& p, const TailRing<N, P::kCarry>& q,
                                          uint32_t head, int n, int lane, int k, int ref_k,
                                          const uint32_t* __restrict__ kmap_keys,
                                          uint32_t* __restrict__ state, int64_t counts_len,
                                          uint64_t n_buckets, uint64_t size_bits) {
  __syncwarp();  // the entries were written by other lanes
  if (lane >= n) return;
  using Ring = TailRing<N, P::kCarry>;
  const uint32_t e = (head + lane) & (Ring::kRing - 1);
  uint32_t w[N];
#pragma unroll
  for (int j = 0; j < N; ++j) w[j] = q.ctx[j][e];
  const uint32_t what = q.what[e], cnt = q.cnt[e];
  const uint32_t carried = Ring::kCarries ? q.carried[Ring::kCarries ? e : 0] : what >> 2;
  uint32_t bit = 0, word = ~0u;  // the context counts as known where the Bloom bit is clear
  if (what & 1u) word = p.context_word(w, carried, ref_k, size_bits, bit);
  int64_t slot = -1;
  if (what & 2u) {
    uint32_t can[N];
    canonical_centre(w, k, ref_k, can);
    slot = probe_buckets(kmap_keys, n_buckets, (k + 15) / 16, can,
                         (uint64_t)q.h_hi[e] << 32 | q.h_lo[e]);
  }
  if (!((word >> bit) & 1u)) atomicAdd(state + q.cidx[e], cnt);
  if (slot >= 0) atomicAdd(state + counts_len + slot, cnt);
}

// The step over B lanes of (B, N) packed contexts and (B,) counters, with
// the (rows, 2) [word, rank | mini-filter << 28] rows `bf_packed`, the
// exact map's (n_buckets, 4 w_k) bucket keys, and the state [counters
// (counts_len) | map values].
template <int N, class P>
__device__ __forceinline__ void step_body(const P& p, const uint32_t* __restrict__ ctx,
                                          const uint32_t* __restrict__ counters, int64_t B, int k,
                                          int ref_k, const uint2* __restrict__ bf_packed,
                                          const uint32_t* __restrict__ kmap_keys,
                                          uint32_t* __restrict__ state, int64_t counts_len,
                                          uint64_t n_buckets, uint64_t size_bits,
                                          int minifilter) {
  using S = Shape<N>;
  using Ring = TailRing<N, P::kCarry>;
  constexpr int L = S::kLanes, kRing = Ring::kRing;
  constexpr bool kFlags = P::kCarry == Carry::kStagedFlag;
  __shared__ __align__(16) uint32_t tiles[kStepWarps][2][S::kTileWords];
  __shared__ __align__(16) uint32_t cnts[kStepWarps][2][S::kTileLanes];
  __shared__ __align__(16) uint32_t flags[kStepWarps][2][kFlags ? S::kTileLanes : 1];
  __shared__ Ring rings[kStepWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Ring& ring = rings[warp];
  const int64_t n_tiles = (B + S::kTileLanes - 1) / S::kTileLanes;
  const int64_t stride = (int64_t)gridDim.x * kStepWarps;
  const bool use_mf = minifilter && n_buckets > 1;
  auto tails = [&](uint32_t head, int n) {
    run_tails<N>(p, ring, head, n, lane, k, ref_k, kmap_keys, state, counts_len, n_buckets,
                 size_bits);
  };

  // A software pipeline over this warp's tiles, each staged in one of two
  // slices in turn.  In each turn the next tile's copy starts first, then
  // tile t's row gathers are issued; while they are in flight the warp
  // runs a full pass of queued tails, if there is one, and hashes the next
  // tile; then it queues tile t's lanes that go on, from its slice.  So
  // the tails' dependent reads and atomics overlap the gathers too, and a
  // pass of them has every lane busy.
  int64_t t = (int64_t)blockIdx.x * kStepWarps + warp;
  int b = 0;  // the slice of tile t
  uint64_t c[L] = {};
  uint32_t live = 0, head = 0, n_queued = 0;
  if (t < n_tiles) {
    p.template stage<N>(tiles[warp][0], cnts[warp][0], flags[warp][0], ctx, counters,
                        t * S::kTileLanes, B, lane);
    live = centre_hashes<N>(p, tiles[warp][0], cnts[warp][0], k, ref_k, size_bits, lane, c);
  }
  for (; t < n_tiles; b ^= 1) {
    const int64_t next = t + stride;
    if (next < n_tiles)
      p.template stage<N>(tiles[warp][b ^ 1], cnts[warp][b ^ 1], flags[warp][b ^ 1], ctx,
                          counters, next * S::kTileLanes, B, lane);
    uint2 row[L];
#pragma unroll
    for (int r = 0; r < L; ++r) {
      const uint64_t idx = bloom_index(c[r], size_bits);
      row[r] = (live >> r) & 1u ? __ldg(bf_packed + p.row(idx)) : make_uint2(0, 0);
    }

    for (; n_queued >= 32; head += 32, n_queued -= 32) tails(head, 32);

    uint64_t cn[L] = {};
    const uint32_t live_next =
        next < n_tiles ? centre_hashes<N>(p, tiles[warp][b ^ 1], cnts[warp][b ^ 1], k, ref_k,
                                          size_bits, lane, cn)
                       : 0;

    // Queue tile t's lanes that go on.  Fewer than 32 entries were left
    // above, so the ring (2 kTileLanes >= 32 + kTileLanes) holds this
    // tile's kTileLanes more.
    __syncwarp();  // the pass above has read its entries
    const uint32_t* tile = tiles[warp][b];
    const uint32_t* tile_cnt = cnts[warp][b];
#pragma unroll
    for (int r = 0; r < L; ++r) {
      const RowTest rt = row_test(row[r].x, row[r].y, c[r], size_bits, minifilter, use_mf);
      const uint32_t what = ((live >> r) & 1u) * rt.what;
      const unsigned go = __ballot_sync(0xFFFFFFFFu, what != 0);
      if (what) {
        const uint32_t e = (head + n_queued + __popc(go & ((1u << lane) - 1u))) & (kRing - 1);
        const int slot = r * 32 + lane;
#pragma unroll
        for (int j = 0; j < N; ++j) ring.ctx[j][e] = tile[slot * N + j];
        ring.cnt[e] = tile_cnt[slot];
        ring.h_hi[e] = (uint32_t)(c[r] >> 32);
        ring.h_lo[e] = (uint32_t)c[r];
        ring.cidx[e] = rt.cidx;
        ring.what[e] = kFlags ? what | (uint32_t)(flags[warp][b][slot] != 0u) << 2 : what;
        if constexpr (P::kCarry == Carry::kLaneIndex)
          ring.carried[e] = (uint32_t)(t * S::kTileLanes + slot);
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

// The blocks of a persistent grid for the step over B lanes, into *grid.
template <int N, typename Kernel>
int step_grid(Kernel kernel, int64_t B, int* grid) {
  constexpr int64_t per_block = (int64_t)Shape<N>::kTileLanes * kStepWarps;
  return persistent_grid(kernel, kStepThreads, 0, (B + per_block - 1) / per_block, grid);
}

}  // namespace malva

#define MALVA_WORD_COUNTS(F) \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) F(11) F(12) F(13) F(14) F(15)
