// K6 and K7: the two partition kernels of the routed sharded call step, and
// the launcher of the step's card-to-card copies.  The sharded context
// scan's chunk step, K8 (scan_pack, whose tiles end in the same partition,
// and whose prologue sets the previous chunk's rows: ref_scan.cu) and the
// copies, is one C call here too.
//
// No Pallas counterpart.  They replace pack_dests (malva_tpu/parallel/
// sharded_index.py:326-347, a sort by owner into a (D * cap) slot matrix
// with an overflow flag) and the hop-1 owner's context-filter test (:383-
// 394) of make_routed_call_step, which feed two all_to_alls.  On a GPU the
// hops are fixed-size card-to-card copies, so the sizes are known when the
// copies are issued and a step needs no host read.
//
// A slot block holds the rows a source sends to one destination in a hop,
// in the format launch.cuh defines (kSlotHead, kHop1Cols, kHop2Cols); K4's
// slot entry (shard_step.cu) reads hop 2's.  Rows keep their lane order
// within a destination, as pack_dests' stable sort does, so the slots are
// deterministic; a lane whose rank reaches cap is appended instead to the
// source card's overflow list ([contexts (ovf_cap x N) | counters
// (ovf_cap)], at a place taken by atomic add on tally[0]), which the
// session reruns once, at its end.  Counter adds commute, so the state
// does not depend on either order.
//
// Each kernel is one launch over tiles of kTileLanes lanes (route.cuh holds
// the tile logic, which the g++ tests run; partition.cuh the look-back).  A
// tile takes its index from a ticket, so it waits only on tiles that started before it.  Its threads
// load their lanes' words (coalesced, every read in flight before any is
// used; K7's random context-filter reads too) and rank them by
// destination, warp by warp with ballots, then over the warps with one
// scan.  The tile publishes its count per destination to the scratch (a
// 64-bit status word each), starts copying its contexts into their places
// in shared memory (cp.async, grouped by destination), and its warp 0
// looks back over the statuses of the tiles before it, a window of 16 x 32
// / D' tiles a step, for its base per destination (decoupled look-back).
// Then each of a destination's planes gets its rows as one run, with
// 16-byte stores where the run is aligned; rows past cap go the same way
// to the overflow list, whose place the tile takes with one atomic add.
// The last tile writes every header (min(total, cap)) and adds it to the
// tally; the tile that finishes last resets the scratch for the next
// launch, so the scratch is zeroed once, when it is made.  K7's lanes are
// the live rows of its input blocks, block after block (route.cuh
// lane_block, which K4's slot entry shares), so no tile of its launch holds
// only stale rows.
//
// Bound: bytes.  K6 reads the hash planes, contexts and counters of its
// lanes (16 + 4N + 4 bytes each) and writes one row of 4 (N + 4) bytes;
// K7 reads the received rows, one random context-filter word per row, and
// writes rows of 4 (N + 2) bytes.  All of a launch's tiles are resident at
// once at the main path's sizes, so a launch is a read phase, the
// look-back's wait for the slowest tile, then a write phase.  K7's random
// reads each fetch a 32-byte sector for 4 bytes and take most of its time
// (PERF.md).  chip_smoke.py counts the bytes and times both beside that
// bound.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "launch.cuh"
#include "partition.cuh"
#include "route.cuh"

using namespace malva;

namespace {

static_assert(PackLanes::kSlotCols == kHop1Cols && ProbeLanes::kSlotCols == kHop2Cols,
              "the lanes' columns are the slot format's");
static_assert(1 << kDestBits == kMaxDests, "a destination fits its bits");

// Tile t of a launch of K6 or K7 (Src), which holds `live` lanes that can
// hold a row: rank, publish, look back, stage, write.
template <class Src>
__device__ __forceinline__ void route_tile(const Src& src, int64_t t, int live, int64_t last,
                                           int D, const Blocks& out, int64_t cap,
                                           uint32_t* __restrict__ ovf, int64_t ovf_cap,
                                           unsigned long long* __restrict__ tally, int tally_at,
                                           unsigned long long* __restrict__ status,
                                           TileShared& sh, uint32_t* stage) {
  constexpr int C = Src::kCols;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, N = src.N;
  uint32_t* cols = stage + kTileLanes * N;

  typename Src::Raw raw[kRouteItems] = {};
#pragma unroll
  for (int i = 0; i < kRouteItems; ++i)
    if (item_lane(warp, i, lane) < live)
      raw[i] = src.fetch(t * kTileLanes + item_lane(warp, i, lane), sh.start);
#pragma unroll
  for (int i = 0; i < kRouteItems; ++i)
    if (item_lane(warp, i, lane) < live) src.fetch2(raw[i]);

  // each lane's rank among the warp's lanes of its destination
  const int bits = dest_bits(D);
  const uint32_t lt = (1u << lane) - 1u;
  int dest[kRouteItems];
  uint32_t pos[kRouteItems];
  uint32_t run = 0;  // lane e < D: the warp's lanes so far with destination e
#pragma unroll
  for (int i = 0; i < kRouteItems; ++i) {
    dest[i] = item_lane(warp, i, lane) < live ? src.dest(raw[i], D) : D;
    uint32_t ballot[kDestBits];
    const uint32_t valid = __ballot_sync(~0u, dest[i] < D);
#pragma unroll
    for (int b = 0; b < kDestBits; ++b)
      ballot[b] = b < bits ? __ballot_sync(~0u, dest[i] >> b & 1) : 0u;
    const uint32_t own = dest_mask(valid, ballot, bits, dest[i]);
    pos[i] = __shfl_sync(~0u, run, dest[i] & 31) + __popc(own & lt);
    if (lane < D) run += __popc(dest_mask(valid, ballot, bits, lane));
  }
  if (lane < kMaxDests) sh.woff[warp][lane] = lane < D ? run : 0u;
  __syncthreads();

  // warp 0: the tile's counts, published at once, and the staged offsets
  if (warp == 0) {
    if (lane < D) {
      sh.run[lane].tot = warp_offsets(sh.woff, lane);
      publish(status + t * D + lane,
              status_word(t == 0 ? kStatusPrefix : kStatusAggregate, sh.run[lane].tot));
    }
    __syncwarp();
    if (lane < D) {
      const uint32_t soff = sh.run[lane].soff = tot_before(sh.run, lane);
#pragma unroll
      for (int w = 0; w < kRouteWarps; ++w) sh.woff[w][lane] += soff;
    }
  }
  __syncthreads();

  // the contexts into their places, in flight during the look-back
#pragma unroll
  for (int i = 0; i < kRouteItems; ++i) {
    if (dest[i] >= D) continue;
    pos[i] += sh.woff[warp][dest[i]];
    const uint32_t* row = src.ctx_row(t * kTileLanes + item_lane(warp, i, lane), sh.start);
    for (int q = 0; q < N; ++q) cp_async4(stage + pos[i] * N + q, row + q);
  }
  cp_async_commit();
  if (warp == 0) tile_bases(sh, t, last, D, out, cap, tally, tally_at, status);

  // the columns (K7's context-filter reads have had the look-back's time)
#pragma unroll
  for (int i = 0; i < kRouteItems; ++i) {
    if (dest[i] >= D) continue;
    uint32_t col[C];
    src.columns(raw[i], dest[i], col);
#pragma unroll
    for (int c = 0; c < C; ++c) cols[c * kTileLanes + pos[i]] = col[c];
  }
  cp_async_wait_all();
  __syncthreads();

  // each destination's runs, a warp a run
  constexpr int kRuns = run_kinds(Src::kSlotCols, Src::kOvfCols);
  for (int job = warp; job < D * kRuns; job += kRouteWarps) {
    const int e = job / kRuns;
    const Run w = tile_run<Src::kSlotCols, Src::kOvfCols>(job % kRuns, sh.run[e],
                                                          out.at(e) + kSlotHead, stage, cols, N,
                                                          cap, ovf, ovf_cap);
    write_run(w.dst, w.src, w.n, lane, 32);
  }
}

// One launch of K6 or K7 (Src), one block a tile.  Dynamic shared memory:
// the tile's staging (route.cuh stage_words).  scratch: [ticket, tiles
// done, status[tile][D]].  The tiles past the last that holds a lane do
// nothing; the last writes the headers.
template <class Src>
__global__ void __launch_bounds__(kRouteThreads, 2)
    route_kernel(Src src, int D, Blocks out, int64_t cap, uint32_t* __restrict__ ovf,
                 int64_t ovf_cap, unsigned long long* __restrict__ tally, int tally_at,
                 unsigned long long* __restrict__ scratch, int n_tiles) {
  extern __shared__ __align__(16) uint32_t stage[];
  __shared__ TileShared sh;
  unsigned long long* status = scratch + kScratchHead;

  if (threadIdx.x == 0) sh.tile = (int64_t)atomicAdd(scratch, 1ull);
  if ((int)threadIdx.x < D) sh.heads[threadIdx.x] = src.head_rows(threadIdx.x);
  __syncthreads();
  if (threadIdx.x == 0) block_starts(sh.heads, D, sh.start);
  __syncthreads();
  const int64_t t = sh.tile, lanes = src.lanes(sh.start), last = last_tile(lanes);
  if (t <= last)
    route_tile(src, t, tile_live(lanes, t), last, D, out, cap, ovf, ovf_cap, tally, tally_at,
               status, sh, stage);

  // the tile that finishes last resets the scratch: every look-back is over
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    sh.last_done = atomicAdd(scratch + 1, 1ull) == (unsigned long long)(n_tiles - 1);
  }
  __syncthreads();
  if (sh.last_done) {
    for (int64_t q = threadIdx.x; q < (last + 1) * D; q += kRouteThreads) status[q] = 0;
    if (threadIdx.x == 0) scratch[0] = scratch[1] = 0;
  }
}

// Dynamic shared memory of a launch: the tile's staging.
template <class Src>
size_t stage_bytes(int N) {
  return sizeof(uint32_t) * stage_words(N, Src::kCols);
}

// Lets route_kernel<Src> take the most shared memory any N asks, once per
// card.  Returns the first CUDA error, or 0.
template <class Src>
int allow_stage() {
  static std::atomic<uint64_t> cards{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint64_t bit = 1ull << (dev & 63);
  if (cards.load() & bit) return 0;
  e = cudaFuncSetAttribute(route_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)stage_bytes<Src>(kMaxWords));
  if (e == cudaSuccess) cards.fetch_or(bit);
  return (int)e;
}

template <class Src>
int launch_route(const Src& src, int D, void* const* blocks, int64_t cap, uint32_t* ovf,
                 int64_t ovf_cap, unsigned long long* tally, int tally_at, void* scratch,
                 cudaStream_t stream) {
  if (D < 1 || D > kMaxDests || cap < 1 || src.N < 0 || src.N > kMaxWords ||
      src.tiles() > kMaxTiles)
    return (int)cudaErrorInvalidValue;
  Blocks out{};
  for (int d = 0; d < D; ++d) out.p[d] = (uint32_t*)blocks[d];
  const int err = allow_stage<Src>();
  if (err) return err;
  const int n_tiles = (int)src.tiles();
  route_kernel<Src><<<n_tiles, kRouteThreads, stage_bytes<Src>(src.N), stream>>>(
      src, D, out, cap, ovf, ovf_cap, tally, tally_at, (unsigned long long*)scratch, n_tiles);
  return (int)cudaGetLastError();
}

// The columns of a routed step's plan: one row of int64 per shard, filled
// once by the router (its buffers) and each step (its slice, stream and
// events); pointers as integers; kCounts is K6's and K7's scratch; kOut1
// and kOut2 begin kMaxDests columns each.  This file owns the order:
// ops/kernels.py reads each column's index by its name in kPlanNames
// (malva_route_plan_col).
enum PlanCol {
  kDev, kHx, kRecv1, kRecv2, kOvf, kOvfCap, kTally, kCounts, kCtxWords, kBfPacked, kNWords,
  kKmapKeys, kState, kCtx, kCounters, kRows, kStream, kEvHash0, kEvHash1, kEvUpd0, kEvUpd1,
  kOut1, kOut2 = kOut1 + kMaxDests, kPlanCols = kOut2 + kMaxDests
};

struct PlanName {
  const char* name;
  int col;
};
constexpr PlanName kPlanNames[] = {
    {"dev", kDev},         {"hx", kHx},                 {"recv1", kRecv1},
    {"recv2", kRecv2},     {"ovf", kOvf},               {"ovf_cap", kOvfCap},
    {"tally", kTally},     {"counts", kCounts},         {"ctx_words", kCtxWords},
    {"bf_packed", kBfPacked}, {"n_words", kNWords},     {"kmap_keys", kKmapKeys},
    {"state", kState},     {"ctx", kCtx},               {"counters", kCounters},
    {"rows", kRows},       {"stream", kStream},         {"ev_hash0", kEvHash0},
    {"ev_hash1", kEvHash1}, {"ev_upd0", kEvUpd0},       {"ev_upd1", kEvUpd1},
    {"out1", kOut1},       {"out2", kOut2},             {"width", kPlanCols},
    {"max_dests", kMaxDests}};

// The columns of a sharded scan step's plan (malva_sharded_scan_step): one
// row of int64 per shard, filled once by the scan (its buffers: one plan for
// each parity of the chunks, whose blocks are the receive buffers of that
// parity) and each chunk (its slice of the contig and the launcher's
// events); kSSet, the D blocks the shard received in the previous chunk
// (the other parity), whose rows K8's prologue sets; kOut begins kMaxDests
// columns, the blocks the shard writes for each owner.  ops/kernels.py
// reads each column's index by its name (malva_scan_plan_col).
enum ScanCol {
  kSDev, kSStream, kSSeq, kSNPos, kSBfWords, kSOvf, kSTally, kSScratch, kSSet,
  kSCtxWords, kSEvPack0, kSEvPack1, kSOut, kScanCols = kSOut + kMaxDests
};

constexpr PlanName kScanNames[] = {
    {"dev", kSDev},          {"stream", kSStream},       {"seq", kSSeq},
    {"n_pos", kSNPos},       {"bf_words", kSBfWords},    {"ovf", kSOvf},
    {"tally", kSTally},      {"scratch", kSScratch},     {"set", kSSet},
    {"ctx_words", kSCtxWords}, {"ev_pack0", kSEvPack0},  {"ev_pack1", kSEvPack1},
    {"out", kSOut},          {"width", kScanCols},       {"max_dests", kMaxDests}};

}  // namespace

extern "C" {

// K1's hash-only launcher (callstep.cu), K4's slot entry (shard_step.cu),
// K8 (ref_scan.cu).
int malva_callstep_hash(const void* ctx, int64_t B, int wc, int k, int ref_k, int with_ctx,
                        void* out, void* ev_start, void* ev_stop, void* stream);
int malva_shard_update_slots(const void* slots, int64_t n_blocks, int64_t cap, int wc, int k,
                             int ref_k, const void* bf_packed, int64_t word_base, int64_t n_words,
                             const void* kmap_keys, void* state, int64_t counts_len,
                             int64_t n_buckets, int64_t size_bits, int minifilter,
                             void* ev_start, void* ev_stop, void* stream);
int malva_route_pack(const void* hx, const void* ctx, const void* counters, int64_t B, int wc,
                     int64_t size_bits, int64_t wps, int D, void* const* blocks, int64_t cap,
                     void* ovf, int64_t ovf_cap, void* tally, void* scratch, void* stream);
int malva_route_probe(const void* in, int64_t cap_in, int wc, const void* ctx_words, int D,
                      void* const* blocks, int64_t cap, void* ovf, int64_t ovf_cap, void* tally,
                      void* scratch, void* stream);
int malva_route_copies(int D, const int* dev, void* const* compute, void* const* produced,
                       void* const* guard, int n, const int* from, const int* to,
                       void* const* dst, void* const* src, int64_t bytes,
                       void* const* streams, void* const* copied);
int malva_scan_pack(const void* seq, int64_t n_pos, int k, int ref_k, const void* bf_words,
                    int64_t size_bits, int64_t wps, int W, int D, void* const* blocks, int64_t cap,
                    void* ovf, int64_t ovf_cap, void* tally, void* scratch, const void* set,
                    void* ctx_words, void* stream);

// The plan column (PlanCol) of `name`, "width" for the row's width and
// "max_dests" for the columns after kOut1 and kOut2; -1 for another name.
int malva_route_plan_col(const char* name) {
  for (const PlanName& p : kPlanNames)
    if (strcmp(p.name, name) == 0) return p.col;
  return -1;
}

// The scan step's plan column (ScanCol) of `name`, as malva_route_plan_col.
int malva_scan_plan_col(const char* name) {
  for (const PlanName& p : kScanNames)
    if (strcmp(p.name, name) == 0) return p.col;
  return -1;
}

// The slot block's format (launch.cuh): what 0 asks for kSlotHead, 1 for
// kHop1Cols, 2 for kHop2Cols; -1 for another.
int malva_slot_layout(int what) {
  return what == 0 ? (int)kSlotHead : what == 1 ? kHop1Cols : what == 2 ? kHop2Cols : -1;
}

// 8-byte words of the scratch of K6's, K7's and K8's launches with D
// destinations ([ticket, tiles (K8: blocks) done, a status per tile and
// destination]), made zeroed once and reset by each launch.  A launch of
// more than kMaxTiles tiles is refused.
int64_t malva_route_scratch_words(int D) { return kScratchHead + (int64_t)kMaxTiles * D; }

// K6 over the B lanes of a source slice: `hx` K1 hash-only's planes (with
// the context hash), `ctx` (B, wc) packed contexts, `counters` (B,); each
// lane with a counter goes to destination cw / wps, into blocks[d] (cap rows
// of hop 1 each), or to the overflow list; the tally gets the overflow at
// [0] and the rows sent to d at [1 + d].  `scratch`: malva_route_scratch_words
// (D) words, zeroed when made.  One kernel launch.
int malva_route_pack(const void* hx, const void* ctx, const void* counters, int64_t B, int wc,
                     int64_t size_bits, int64_t wps, int D, void* const* blocks, int64_t cap,
                     void* ovf, int64_t ovf_cap, void* tally, void* scratch, void* stream) {
  if (wps < 1 || wps > UINT32_MAX || B < 0) return (int)cudaErrorInvalidValue;
  const PackLanes src{(const uint32_t*)hx, (const uint32_t*)ctx, (const uint32_t*)counters, B,
                      (uint32_t)wps, (uint64_t)size_bits, wc};
  return launch_route(src, D, blocks, cap, (uint32_t*)ovf, ovf_cap, (unsigned long long*)tally,
                      1, scratch, (cudaStream_t)stream);
}

// K7 over the D received hop-1 blocks `in` (cap_in rows each) of one shard
// with context words `ctx_words`: each live row goes to its Bloom-word
// owner, into blocks[d] (cap rows of hop 2 each), with its context-filter
// bit, or to the overflow list; the tally gets the rows sent to d at
// [1 + D + d].  `scratch` as K6's.  One kernel launch.
int malva_route_probe(const void* in, int64_t cap_in, int wc, const void* ctx_words, int D,
                      void* const* blocks, int64_t cap, void* ovf, int64_t ovf_cap, void* tally,
                      void* scratch, void* stream) {
  if (cap_in < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const ProbeLanes src{(const uint32_t*)in, (const uint32_t*)ctx_words, cap_in,
                       kSlotHead + cap_in * (wc + kHop1Cols), (int)kSlotHead, wc, D};
  return launch_route(src, D, blocks, cap, (uint32_t*)ovf, ovf_cap, (unsigned long long*)tally,
                      1 + D, scratch, (cudaStream_t)stream);
}

// Peer access from card `dev` to card `peer`, where the pair can have it,
// so that their copies go card to card without the driver staging them;
// enabling it again is no error.  Returns the first CUDA error, or 0.
int malva_enable_peer(int dev, int peer) {
  int cur = 0, can = 0;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess) e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e == cudaSuccess && can) {
    e = cudaSetDevice(dev);
    if (e == cudaSuccess) e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      (void)cudaGetLastError();
      e = cudaSuccess;
    }
  }
  const cudaError_t r = cudaSetDevice(cur);
  return (int)(e != cudaSuccess ? e : r);
}

// One hop's card-to-card copies.  Card s's compute stream compute[s] (on
// card dev[s]) records produced[s]: its blocks are written.  Copy i sends
// `bytes` from src[i] on card dev[from[i]] to dst[i] on card dev[to[i]] on
// a stream of its own, streams[i] (of card dev[from[i]]), after
// produced[from[i]] and, where given, guard[to[i]] (the destination is done
// with the previous contents), and records copied[i]; then the compute
// streams of both ends wait for copied[i], so that no kernel reads a block
// before it lands or writes a source block before it has left.  No host
// wait.  Returns the first CUDA error, or 0.
int malva_route_copies(int D, const int* dev, void* const* compute, void* const* produced,
                       void* const* guard, int n, const int* from, const int* to,
                       void* const* dst, void* const* src, int64_t bytes,
                       void* const* streams, void* const* copied) {
  int cur = 0;
  cudaError_t e = cudaGetDevice(&cur);
  for (int s = 0; s < D && e == cudaSuccess; ++s) {
    e = cudaSetDevice(dev[s]);
    if (e == cudaSuccess) e = cudaEventRecord((cudaEvent_t)produced[s], (cudaStream_t)compute[s]);
  }
  for (int i = 0; i < n && e == cudaSuccess; ++i) {
    const cudaStream_t st = (cudaStream_t)streams[i];
    e = cudaSetDevice(dev[from[i]]);
    if (e == cudaSuccess) e = cudaStreamWaitEvent(st, (cudaEvent_t)produced[from[i]], 0);
    if (e == cudaSuccess && guard) e = cudaStreamWaitEvent(st, (cudaEvent_t)guard[to[i]], 0);
    if (e == cudaSuccess)
      e = cudaMemcpyPeerAsync(dst[i], dev[to[i]], src[i], dev[from[i]], (size_t)bytes, st);
    if (e == cudaSuccess) e = cudaEventRecord((cudaEvent_t)copied[i], st);
  }
  for (int i = 0; i < 2 * n && e == cudaSuccess; ++i) {
    const int end = i < n ? to[i] : from[i - n];
    e = cudaSetDevice(dev[end]);
    if (e == cudaSuccess)
      e = cudaStreamWaitEvent((cudaStream_t)compute[end], (cudaEvent_t)copied[i % n], 0);
  }
  const cudaError_t r = cudaSetDevice(cur);
  return (int)(e != cudaSuccess ? e : r);
}

// One routed step over the D shards of `plan` (PlanCol), in one call, so
// that the host issues a step at the cost of one: on each source, K1
// hash-only and K6; hop 1's copies (malva_route_copies, where n pairs
// cross cards; produced1/2 and copied1/2 are the hops' events); on each
// owner, K7; hop 2's copies; on each owner, K4's slot entry, its Bloom
// words starting at d * wps.  Returns the first CUDA error, or 0.
int malva_routed_step(int D, const int64_t* plan, int wc, int k, int ref_k, int minifilter,
                      int64_t cap, int64_t size_bits, int64_t wps, int64_t n_buckets,
                      int64_t counts_len, int n, const int* dev, const int* from, const int* to,
                      void* const* streams, void* const* produced1, void* const* produced2,
                      void* const* copied1, void* const* copied2, void* const* dst1,
                      void* const* src1, void* const* dst2, void* const* src2, int64_t bytes1,
                      int64_t bytes2) {
  if (D < 1 || D > kMaxDests) return (int)cudaErrorInvalidValue;
  auto at = [&](int s, int c) { return plan[(int64_t)s * kPlanCols + c]; };
  auto ptr = [&](int s, int c) { return (void*)at(s, c); };
  auto blocks = [&](int s, int c) { return (void* const*)(plan + (int64_t)s * kPlanCols + c); };
  int cur = 0;
  int e = (int)cudaGetDevice(&cur);
  void* compute[kMaxDests];
  for (int s = 0; s < D; ++s) compute[s] = ptr(s, kStream);
  for (int s = 0; s < D && !e; ++s) {
    e = (int)cudaSetDevice((int)at(s, kDev));
    if (!e)
      e = malva_callstep_hash(ptr(s, kCtx), at(s, kRows), wc, k, ref_k, 1, ptr(s, kHx),
                              ptr(s, kEvHash0), ptr(s, kEvHash1), compute[s]);
    if (!e)
      e = malva_route_pack(ptr(s, kHx), ptr(s, kCtx), ptr(s, kCounters), at(s, kRows), wc,
                           size_bits, wps, D, blocks(s, kOut1), cap, ptr(s, kOvf),
                           at(s, kOvfCap), ptr(s, kTally), ptr(s, kCounts), compute[s]);
  }
  if (!e && n)
    e = malva_route_copies(D, dev, compute, produced1, produced2, n, from, to, dst1, src1,
                           bytes1, streams, copied1);
  for (int d = 0; d < D && !e; ++d) {
    e = (int)cudaSetDevice((int)at(d, kDev));
    if (!e)
      e = malva_route_probe(ptr(d, kRecv1), cap, wc, ptr(d, kCtxWords), D, blocks(d, kOut2),
                            cap, ptr(d, kOvf), at(d, kOvfCap), ptr(d, kTally), ptr(d, kCounts),
                            compute[d]);
  }
  if (!e && n)
    e = malva_route_copies(D, dev, compute, produced2, produced1, n, from, to, dst2, src2,
                           bytes2, streams, copied2);
  for (int d = 0; d < D && !e; ++d) {
    e = (int)cudaSetDevice((int)at(d, kDev));
    if (!e)
      e = malva_shard_update_slots(ptr(d, kRecv2), D, cap, wc, k, ref_k, ptr(d, kBfPacked),
                                   (int64_t)d * wps, at(d, kNWords), ptr(d, kKmapKeys),
                                   ptr(d, kState), counts_len, n_buckets, size_bits, minifilter,
                                   ptr(d, kEvUpd0), ptr(d, kEvUpd1), compute[d]);
  }
  const int r = (int)cudaSetDevice(cur);
  return e ? e : r;
}

// One chunk of the sharded context scan over the D shards of `plan`
// (ScanCol, the plan of this chunk's parity), in one call: K8 on each
// shard's slice, whose prologue sets the rows the shard received in the
// previous chunk (kSSet) in its context words; then the slot blocks'
// copies between cards (malva_route_copies, where n pairs cross cards:
// produced and copied as in the routed step).  The receive buffers are
// two, by the parity of the chunk, so that this chunk's copies into an
// owner never wait on the prologue that reads the previous chunk's rows:
// done[d] is recorded after K8 on d here (its prologue read the other
// parity's buffer), and guard[d], recorded so after the previous chunk's
// K8 on d (whose prologue read this parity's buffer), gates the copies
// into d, so that no block is overwritten before its owner has set its
// rows.  The caller swaps guard and done from one chunk to the next; the
// last chunk's rows are set by K9 (malva_scan_set) on each owner.  Where a
// shard's ev_pack0/1 are not null, they are recorded around its K8.  No
// host wait.  Returns the first CUDA error, or 0.
int malva_sharded_scan_step(int D, const int64_t* plan, int k, int ref_k, int64_t size_bits,
                            int64_t wps, int W, int64_t cap, int64_t ovf_cap, int n,
                            const int* dev, const int* from, const int* to, void* const* streams,
                            void* const* produced, void* const* guard, void* const* done,
                            void* const* copied, void* const* dst, void* const* src,
                            int64_t bytes) {
  if (D < 1 || D > kMaxDests) return (int)cudaErrorInvalidValue;
  auto at = [&](int s, int c) { return plan[(int64_t)s * kScanCols + c]; };
  auto ptr = [&](int s, int c) { return (void*)at(s, c); };
  auto record = [&](int s, int c) {
    return ptr(s, c) ? (int)cudaEventRecord((cudaEvent_t)ptr(s, c), (cudaStream_t)ptr(s, kSStream))
                     : 0;
  };
  int cur = 0;
  int e = (int)cudaGetDevice(&cur);
  void* compute[kMaxDests];
  for (int s = 0; s < D; ++s) compute[s] = ptr(s, kSStream);
  for (int s = 0; s < D && !e; ++s) {
    e = (int)cudaSetDevice((int)at(s, kSDev));
    if (!e) e = record(s, kSEvPack0);
    if (!e)
      e = malva_scan_pack(ptr(s, kSSeq), at(s, kSNPos), k, ref_k, ptr(s, kSBfWords), size_bits,
                          wps, W, D,
                          (void* const*)(plan + (int64_t)s * kScanCols + kSOut), cap,
                          ptr(s, kSOvf), ovf_cap, ptr(s, kSTally), ptr(s, kSScratch),
                          ptr(s, kSSet), ptr(s, kSCtxWords), compute[s]);
    if (!e) e = record(s, kSEvPack1);
    if (!e && n) e = (int)cudaEventRecord((cudaEvent_t)done[s], (cudaStream_t)compute[s]);
  }
  if (!e && n)
    e = malva_route_copies(D, dev, compute, produced, guard, n, from, to, dst, src, bytes,
                           streams, copied);
  const int r = (int)cudaSetDevice(cur);
  return e ? e : r;
}

}  // extern "C"
